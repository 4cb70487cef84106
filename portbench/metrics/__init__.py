"""One reader per metric, end-to-end or per-layer, found by the metric's
name in `BENCHMARK.json`: `<quantity>.py`, the quantity being the name up to
its first dot, so one quantity split by the end-to-end metric it moves
(`mfu` and `mfu.mem`) has one reader. A reader defines `read(ctx)` → a
number, or None when the run has nothing to read for it, and may define
`install(ctx)` → an undo callable, run around the traced slice to record
what it reads.

`ctx` holds `system` (the counts per epoch), `epochs` (the window's epoch
metrics, with the program's `time/<phase>_s`), `window_s`, `peak_bytes`
(the window's peak of allocated device memory), `setup_s`, `parts` (the
traced slice: `steps` and `update`, each `trace.profile`'s result),
`n_steps` (control steps in the slice) and `records` (what `install` hooks
recorded).
"""
