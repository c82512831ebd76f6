"""From the process's start to the first timed unit: the kernel library's
load (or its build), the weights, the program's models, the warm-up."""

UNIT = "s"
SOURCE = "host_clock"


def read(window):
    return window.setup_s
