"""The system under test, one module per kind of configuration (`algo` in
the configuration's file): `kinds/<algo>.py` defines `System(cfg, mix, seed,
device, root)` with the interface `systems.py` describes, found by that name."""
