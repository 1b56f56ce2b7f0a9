// bad fixture: orphan (never compiled)
extern "C" int orphan_launch(void) { return 0; }
