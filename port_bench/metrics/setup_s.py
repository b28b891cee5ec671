"""Seconds from the process's start to the window's: imports, the
program's build check, the inputs, the program, its first steps and the
warm-up."""


def read(ctx):
    return ctx["setup_s"]
