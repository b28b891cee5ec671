"""Multi-device runs (counterpart of s_volsdf_tpu/parallel/): one process
a card under torchrun, exchanging data through torch.distributed.

- `mesh`: the process group set up from torchrun's environment, the
  node's ranks as a mesh of process groups (`make_group`, `eval_group`),
  the collectives the layouts use, and `run_local_ranks`, which spawns
  ranks on one machine (tests, the dry run, the smoke run).
- `multihost`: scenes partitioned over nodes, and the fusion pool.
- `train_parallel`: the ray-sharded step and loop, and the scene- and
  scene x ray-sharded lockstep loops.
"""
