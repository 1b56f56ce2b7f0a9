// bad fixture: untested (never compiled)
extern "C" int untested_launch(void) { return 0; }
