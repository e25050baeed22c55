"""The general drivers of the benchmark's traffic, one module per ``kind``
that a traffic file names: each builds the program's state from the
configuration and the seed, warms it up, drives its entry point for the
window, and checks what it produced against the configuration's plain
reference."""
