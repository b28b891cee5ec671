"""Image-based rendering command line (counterpart of
s_volsdf_tpu/cli/ibr.py), on "cuda" unless told otherwise:

    python -m s_volsdf_tpu_torch.cli.ibr testlist=scan106 \\
        evals_folder=exps_result

For each scan: the newest all-digit rendering_<epoch> directory under
<evals_folder>/<train.expname>_<id> (what `cli.eval_vsdf
--eval_rendering` writes: the renders and depth_est/ PFMs of every
view) and the scene export <outdir>/<scan> (`cli.run create_scene=true`)
feed `engine.ibr.image_based_render`, which writes eval_blend_XXX.png
beside the renders (`cli.eval_vsdf --result_from blend` scores them).
`+key=value` works like `key=value`; `preset=` (or the hydra group
`vol=`) picks the preset.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import List

from s_volsdf_tpu_torch.cli.run import parse_overrides, parse_testlist
from s_volsdf_tpu_torch.config import load_config
from s_volsdf_tpu_torch.engine.ibr import image_based_render

logger = logging.getLogger("s_volsdf_tpu_torch")


def main(argv: List[str], *, device=None) -> List[str]:
    """Blend the eval views of argv's scans on `device` ("cuda" by
    default; device="cpu" runs it on the CPU). Returns the blends'
    paths."""
    preset, overrides = parse_overrides(argv)
    evals_folder = overrides.pop("evals_folder", "exps_result")

    cfg = load_config(preset, overrides=[f"{k}={v}"
                                         for k, v in overrides.items()])
    written = []
    for scan in parse_testlist(cfg.testlist):
        evaldir = os.path.join(evals_folder,
                               f"{cfg.train.expname}_{int(scan[4:])}")
        if not os.path.isdir(evaldir):
            raise SystemExit(
                f"{scan}: no eval dir {evaldir} — run the eval renderer "
                f"(s-volsdf-eval --eval_rendering) first")
        # Only all-digit rendering_<N> directories count: a stray
        # rendering_tmp entry or a plain file must not win.
        epochs = [int(d[len("rendering_"):]) for d in os.listdir(evaldir)
                  if d.startswith("rendering_")
                  and d[len("rendering_"):].isdigit()
                  and os.path.isdir(os.path.join(evaldir, d))]
        if not epochs:
            raise SystemExit(
                f"{scan}: {evaldir} holds no rendering_<epoch> dirs — run "
                f"the eval renderer (s-volsdf-eval --eval_rendering) first")
        out_folder = os.path.join(evaldir, f"rendering_{max(epochs)}")
        scan_folder = os.path.join(cfg.outdir, scan)
        if not os.path.isdir(scan_folder):
            raise SystemExit(
                f"{scan}: no scene export {scan_folder} — run "
                f"`s-volsdf create_scene=true` first")
        logger.info(f"IBR {scan}: cams/imgs from {scan_folder}, "
                    f"renders in {out_folder}")
        written += image_based_render(scan_folder, out_folder,
                                      cfg.dataset.data_dir, cfg.num_view,
                                      device=device)
    return written


def cli() -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main(sys.argv[1:])


if __name__ == "__main__":
    cli()
