"""Drivers, one a kind of traffic (a traffic file's ``kind``): each has
``setup(run)``, ``window(run, state, seconds)``, ``outputs(run, state)``
(the program's answers to the sample when no window ran),
``control_outputs(run, state, precision, fault)`` (the reference put in
the program's place) and ``check(run, state)`` (each compared number)."""
