"""Stage modules, found by the ``stage`` a traffic file names.  Each module
has a ``Stage(run)`` with ``setup()`` (inputs from the seed, one warm unit),
``unit(i)`` (one stage call, as a ``cli`` process makes it; returns its
record), ``end_to_end(units, window_s)``, ``release()`` (the program's state
freed) and ``check()``: the readings against the plain reference, all and
by unit; the cell's file gives the limits of those that are compared."""
