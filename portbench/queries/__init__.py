"""Query kinds, one file each (`<kind>.py`), found by the name a traffic
mix gives: the port's program, the plain reference and the comparison."""
