"""Drivers. A traffic file's `driver` names the module
benchmark/drivers/<driver>.py that runs its cells, which gives:

- `run(ctx)`: one run of the cell (set-up, the window, the comparison);
- `SHORT`: the traffic keys that CPU tests replace, to cut the traffic;
- `reference_checks(ctx, exact, low)`: the cell's numbers with the plain
  reference `low`, in a control's rounding, in the program's place, and
  `exact` (fp32) as the yardstick (benchmark/control.py): (numbers, each
  video's record or None).

It may also give `FAULTS` ({control name: a context manager that plants
the fault in the program}), `CAUGHT_BY` ({control name: the checks one
of which it has to fail}) and `program_checks(ctx)`, the program's own
entry where it is not the cell's run (control.py)."""

CONTRACT = ("run", "SHORT", "reference_checks")
