"""The pipeline's command line (counterpart of s_volsdf_tpu/cli/run.py:
15-71): hydra-style dotted `key=value` overrides, run on "cuda".

    python -m s_volsdf_tpu_torch.cli.run testlist=scan106
    python -m s_volsdf_tpu_torch.cli.run testlist=scan106 filter_only=true
    python -m s_volsdf_tpu_torch.cli.run testlist=scan106 create_scene=true

Each scene of `testlist` (a comma list, or a .txt file of scan names) runs
the cascade with VolSDF feedback and writes its depth maps
(`save_depth`, skipped with filter_only=true; with multiscene=true and
more than one scene, `engine.multiscene.save_depth_multiscene`, whose
VolSDF optimisations of a stage run in lockstep); then fusion writes
<outdir>/mvsnet{id:03d}_l3.ply (`pcd_filter`). create_scene=true only
writes each scene's cams and training images for image-based rendering
(`engine.ibr.create_scene`, then `cli.ibr`). `+key=value` works like
`key=value`; `preset=` (or the hydra group `vol=`) picks the dtu, bmvs
or default preset; `mvs_weights=` names a converted cascade checkpoint.
Precision follows the JAX package's knobs and defaults (bf16 training
products and activations, bf16 MVS volumes and cascade convs, float32
renders); `train.train_compute_dtype=float32` and the like pick float32.

Under torchrun, one process a card:

    torchrun --nproc_per_node=N -m s_volsdf_tpu_torch.cli.run \
        testlist=scan106,scan114 [multiscene=true]

the process group is set up from torchrun's environment (NCCL, each
rank on cuda:LOCAL_RANK; gloo with device="cpu") and torn down at the
end. The scenes are partitioned over the nodes, and on a node the
layouts follow `parallel.*` as the JAX package's follow its devices:
the cascade one view a rank, each scene's rays sharded over the ranks
(shard_rays; multiscene=true picks among the scene-sharded layouts,
engine/multiscene._pick_loop), the renders sharded (shard_eval). The
node's first rank writes the outputs, once.
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, List, Tuple

from s_volsdf_tpu_torch.config import load_config, validate_config
from s_volsdf_tpu_torch.engine import ibr
from s_volsdf_tpu_torch.engine.multiscene import save_depth_multiscene
from s_volsdf_tpu_torch.engine.runner import pcd_filter, save_depth
from s_volsdf_tpu_torch.parallel.mesh import launched

logger = logging.getLogger("s_volsdf_tpu_torch")

_TRUE = ("1", "true", "yes")


def parse_testlist(testlist: str) -> List[str]:
    """A file of scan names, or a comma list."""
    if "txt" in testlist:
        with open(testlist) as f:
            return [line.rstrip() for line in f if line.strip()]
    return [x for x in testlist.replace(" ", "").split(",") if x]


def parse_overrides(argv: List[str]) -> Tuple[str, Dict[str, str]]:
    """argv's `key=value` overrides (`+key=value` alike) as a dict, and
    the preset that `preset=` or the hydra group `vol=` picks ("dtu" by
    default)."""
    extra = {k.lstrip("+"): v
             for k, v in (o.split("=", 1) for o in argv if "=" in o)}
    # Pop 'vol' on its own line: a default argument of pop() would be
    # evaluated eagerly and swallow 'vol=' whenever 'preset=' is given.
    vol = extra.pop("vol", None)
    preset = extra.pop("preset", None)
    if preset and vol and preset != vol:
        raise SystemExit(f"conflicting preset={preset} and vol={vol}")
    return preset or vol or "dtu", extra


def main(argv: List[str], *, device=None) -> List[str]:
    """Run the pipeline for argv's overrides on `device` ("cuda" by
    default; device="cpu" runs it on the CPU). Returns the fused PLYs'
    paths (none with create_scene=true)."""
    preset, extra = parse_overrides(argv)
    create_scene = extra.pop("create_scene", "false").lower() in _TRUE
    multiscene = extra.pop("multiscene", "false").lower() in _TRUE
    mvs_weights = extra.pop("mvs_weights", None)

    cfg = validate_config(load_config(
        preset, overrides=[f"{k}={v}" for k, v in extra.items()]))
    testlist = parse_testlist(cfg.testlist)
    logger.info(f"testlist={testlist} outdir={cfg.outdir} "
                f"exps={cfg.exps_folder}")

    if create_scene:
        for scene in testlist:
            ibr.create_scene(cfg, scene)
        return []
    with launched(device) as device:
        if not cfg.filter_only:
            if multiscene and len(testlist) > 1:
                save_depth_multiscene(cfg, testlist, mvs_weights=mvs_weights,
                                      device=device)
            else:
                save_depth(cfg, testlist, mvs_weights=mvs_weights,
                           device=device)
        return pcd_filter(cfg, testlist, device=device)


def cli() -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main(sys.argv[1:])


if __name__ == "__main__":
    cli()
