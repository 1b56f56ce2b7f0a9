// bad fixture: rescued (never compiled)
extern "C" int rescued_launch(void) { return 0; }
