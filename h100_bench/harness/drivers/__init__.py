"""One module a traffic kind (`traffic/<mix>.json`'s `kind`): each builds
the program for the cell, warms it, runs the measured window and hands
back what the run reports and the check that decides `correct`."""
