"""The end-to-end rate of every closed-loop cell: the wall time from the
window's first unit's start to its last one's end over the units completed
(the unit in flight at the window's close finished and counted)."""


def read(window):
    return window.window_s / window.units
