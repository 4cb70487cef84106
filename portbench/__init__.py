"""The benchmark of the PyTorch + CUDA port (`isaacgyminsertion_tpu_torch`).

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`: the
networks' published widths, the algorithm's hyperparameters and the limits
of the correctness check) and a traffic mix (`traffic/<name>.json`: the env
count, the sensors and the resets). Each per-layer metric is a reader of its
own (`metrics/<name>.py`). A configuration names its algorithm (`algo`: the
system under test in `kinds/<algo>.py`, the reference's side in
`reference/kinds/<algo>.py`) and the kind of each network (`kind`:
`reference/nets/<kind>.py`), so a new one arrives as new files. `work/`
holds the frozen counts of operations and bytes, `reference/` the plain
reference that decides `correct`. Nothing here imports JAX or the JAX
package; `reference/` imports nothing of the port.
"""
