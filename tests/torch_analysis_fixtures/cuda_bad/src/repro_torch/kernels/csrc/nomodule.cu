// bad fixture: nomodule (never compiled)
extern "C" int nomodule_launch(void) { return 0; }
