"""One module a kind of cell, named by a traffic file's ``kind``; each has
a class ``Cell``."""
