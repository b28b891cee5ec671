"""The benchmark of the PyTorch and CUDA port, `s_volsdf_tpu_torch`: one
cell a run (`python3 -m port_bench.run`), driven by BENCHMARK.json and
the data files beside this one. It imports neither JAX nor the JAX
package.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds 51 --trace 0
    python3 -m port_bench.calibrate --workload <name> --seeds 1 2 3 --what program control
    python -m pytest port_bench/tests            # the CPU tests
    python -m pytest port_bench/tests -m cuda    # each cell on a card
"""
