// bad fixture: undispatched (never compiled)
extern "C" int undispatched_launch(void) { return 0; }
