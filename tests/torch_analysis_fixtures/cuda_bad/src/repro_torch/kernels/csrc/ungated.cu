// bad fixture: ungated (never compiled)
extern "C" int ungated_launch(void) { return 0; }
