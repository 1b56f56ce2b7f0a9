// bad fixture: noref (never compiled)
extern "C" int noref_launch(void) { return 0; }
