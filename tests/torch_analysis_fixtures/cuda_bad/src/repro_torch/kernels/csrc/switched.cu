// bad fixture: switched (never compiled)
extern "C" int switched_launch(void) { return 0; }
