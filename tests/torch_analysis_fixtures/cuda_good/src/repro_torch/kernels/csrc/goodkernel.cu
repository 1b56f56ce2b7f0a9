// good fixture: the kernel's source (never compiled)
extern "C" int goodkernel_launch(void) { return 0; }
