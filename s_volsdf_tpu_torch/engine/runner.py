"""The per-scene pipeline: the 3-stage MVS cascade (CasMVSNet, UCSNet or
TransMVSNet) interleaved with VolSDF optimisation and depth feedback
(counterpart of s_volsdf_tpu/engine/runner.py:46-250, 321-353, 377-516,
519-561, 604-626).

save_scene_depth, per scene:
  (a) runs the frozen cascade stage by stage (per-view features once per
      scene, TransMVSNet's FMT once per sample, a cost volume per stage
      per reference view; UCSNet's variance and TransMVSNet's view
      weights carried from each stage to the next as the view's
      `extra`),
  (b) at a stage with an optimisation budget, hands the probability
      volumes to the VolSDF trainer (they stay on the device), trains,
      renders VolSDF depth for each training view and feeds it to the
      next stage as its hypothesis centre,
  (c) writes the depth and confidence PFMs, their PNG visualisations,
      the cam files and the images/ copy.

pcd_filter then fuses each scene's depth maps into its point cloud
(engine/fusion.py), over `cfg.num_worker` processes when there are
several scenes (`parallel.multihost.map_scenes_host_pool`). The trainer
writes its run directory and checkpoints under
{exps_root}/{exps_folder} and, with is_continue, resumes from the
newest.

Under a process group (parallel/) the scenes are partitioned over the
nodes (`partition_scenes`), and the node's ranks run each of its scenes
together: with as many ranks as reference views (and views of one
shape) each stage runs one view a rank, and every rank then holds every
view's outputs, since each rank's cost mapping reads all the volumes
(`_view_group`; the JAX package's `_view_mesh`); the trainer shards
its rays and the feedback renders theirs. The node's first rank alone
writes the depth maps, their PNGs, the cams and images and the point
cloud.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from s_volsdf_tpu_torch.bridge import load_mvs_checkpoint
from s_volsdf_tpu_torch.config import (Config, check_mvs_ported,
                                       per_scene_overrides, save_config,
                                       validate_config)
from s_volsdf_tpu_torch.data.io import save_pfm, write_cam, write_png
from s_volsdf_tpu_torch.data.mvs_dataset import MVSDataset
from s_volsdf_tpu_torch.data.scene_dataset import load_scene
from s_volsdf_tpu_torch.data.splits import get_trains_ids
from s_volsdf_tpu_torch.engine.fusion import filter_depth
from s_volsdf_tpu_torch.engine.trainer import VolTrainer
from s_volsdf_tpu_torch.models.mvs import blocks as B
from s_volsdf_tpu_torch.models.mvs.casmvsnet import (casmvsnet_features,
                                                     casmvsnet_stage,
                                                     init_casmvsnet)
from s_volsdf_tpu_torch.models.mvs.fmt import fmt_with_pathway
from s_volsdf_tpu_torch.models.mvs.transmvsnet import (init_transmvsnet,
                                                       trans_feature_net,
                                                       transmvsnet_stage)
from s_volsdf_tpu_torch.models.mvs.ucsnet import (init_ucsnet,
                                                  ucsnet_features,
                                                  ucsnet_stage)
from s_volsdf_tpu_torch.ops.fused_sdf import fused_sdf_values
from s_volsdf_tpu_torch.parallel.mesh import is_writer, node_group
from s_volsdf_tpu_torch.parallel.multihost import (map_scenes_host_pool,
                                                   partition_scenes)
from s_volsdf_tpu_torch.utils.device import full_float32, resolve_device
from s_volsdf_tpu_torch.utils.viz import visualize_depth

logger = logging.getLogger("s_volsdf_tpu_torch")


class MVSEngine:
    """The frozen cascade (mvs.model_name: casmvsnet, ucsnet or
    transmvsnet) on one device. Weights come from a converted checkpoint
    (`python -m s_volsdf_tpu_torch.tools.convert_ckpt`) or are random
    from `rng_seed`. UCSNet is
    built without mvs.cr_base_chs, as the JAX engine builds it.

    With mvs.compute_dtype="bfloat16" (the JAX default) the conv kernels
    are cast to bf16 once, after loading (`blocks.cast_conv_weights`).
    Its float32 work runs in full float32 on the card whatever the
    global TF32 flags say (`utils.device.full_float32`, around every
    call into the net)."""

    def __init__(self, cfg: Config, weights_path: Optional[str] = None,
                 rng_seed: int = 0, *, device):
        self.cfg = cfg
        check_mvs_ported(cfg.mvs)
        self.name = cfg.mvs.model_name
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(rng_seed)
        if self.name == "ucsnet":
            self.net = init_ucsnet(gen, stage_configs=cfg.mvs.ndepths,
                                   device=self.device)
        else:
            init = (init_casmvsnet if self.name == "casmvsnet"
                    else init_transmvsnet)
            self.net = init(gen, ndepths=cfg.mvs.ndepths,
                            cr_base_chs=cfg.mvs.cr_base_chs,
                            device=self.device)
        if weights_path and os.path.exists(weights_path):
            load_mvs_checkpoint(self.net, weights_path)
            logger.info(f"loaded MVS weights from {weights_path}")
        else:
            logger.warning(
                f"MVS model '{self.name}' running with RANDOM weights "
                f"(no checkpoint at {weights_path}); convert a torch "
                f"ckpt with python -m s_volsdf_tpu_torch.tools.convert_ckpt "
                f"for real runs")
        if cfg.mvs.compute_dtype == "bfloat16":
            B.cast_conv_weights(self.net)

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def scene_feature_cache(self, imgs_all: np.ndarray) -> Dict:
        """The per-view features of a scene's training views (V, H, W, 3),
        computed once per scene: the pyramids ("feats"), or for
        TransMVSNet the DCN backbone's ("backbone"; the FMT mixes the
        views of a sample, `sample_features`)."""
        imgs = self._put(imgs_all).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad(), full_float32():
            if self.name == "transmvsnet":
                return {"backbone": trans_feature_net(self.net.feature, imgs)}
            features = (casmvsnet_features if self.name == "casmvsnet"
                        else ucsnet_features)
            return {"feats": features(self.net, imgs)}

    def sample_features(self, cache: Dict, perm: List[int]) -> List[Dict]:
        """One sample's features in its view order `perm` (indices into
        the cache, reference first). For TransMVSNet the FMT over the
        backbone's, computed once per sample and kept in `cache`: the
        stages share it."""
        if self.name != "transmvsnet":
            return [cache["feats"][p] for p in perm]
        fmt = cache.setdefault("fmt", {})
        key = tuple(perm)
        if key not in fmt:
            with torch.no_grad(), full_float32():
                fmt[key] = fmt_with_pathway(
                    self.net.fmt, [cache["backbone"][p] for p in perm])
        return fmt[key]

    def stage(self, stage_idx: int, features, proj, depth_values,
              prev_depth, extra, img_hw, inverse_depth: bool
              ) -> Tuple[Dict, Optional[torch.Tensor]]:
        """One cascade stage of one sample; `features` are its views'
        (`sample_features`). Returns (outputs, extra): `extra` threads
        UCSNet's variance and TransMVSNet's view weights from one stage
        to the next (None for CasMVSNet)."""
        cfg = self.cfg.mvs
        prev = None if prev_depth is None else self._put(prev_depth)
        args = (self.net, stage_idx, features, self._put(proj),
                self._put(depth_values), prev)
        with torch.no_grad(), full_float32():
            if self.name == "casmvsnet":
                return casmvsnet_stage(
                    *args, img_hw, ndepths=cfg.ndepths,
                    depth_inter_r=cfg.depth_inter_r,
                    inverse_depth=inverse_depth), None
            if self.name == "ucsnet":
                out = ucsnet_stage(*args, extra, img_hw,
                                   stage_configs=cfg.ndepths,
                                   inverse_depth=inverse_depth)
                return out, out["variance"]
            return transmvsnet_stage(*args, extra, img_hw,
                                     ndepths=cfg.ndepths,
                                     depth_inter_r=cfg.depth_inter_r,
                                     inverse_depth=inverse_depth)


def setup_scene(cfg: Config, scene_name: str, *, exps_root: str = ".",
                device) -> Dict:
    """The per-scene pieces: the MVS samples, the loaded scene and its
    VolTrainer, and the empty per-stage accumulators."""
    validate_config(cfg)
    outdir = os.path.join(exps_root, cfg.outdir)
    os.makedirs(os.path.join(outdir, scene_name), exist_ok=True)
    if is_writer():
        save_config(cfg, os.path.join(outdir, scene_name, "args.yaml"))

    trains_i = get_trains_ids(cfg.dataset.data_dir, scene_name, cfg.num_view)
    mvs_datapath = os.path.join(cfg.data_dir_root, cfg.dataset.data_dir,
                                "mvs_data")
    dataset = MVSDataset(
        datapath=mvs_datapath, scan=scene_name, nviews=cfg.num_view,
        data_dir=cfg.dataset.data_dir, ndepths=cfg.mvs.numdepth,
        interval_scale=(cfg.mvs.interval_scale
                        if cfg.dataset.data_dir == "DTU" else 1.0),
        max_h=cfg.max_h, max_w=cfg.max_w, trains_i=trains_i,
        data_dir_root=cfg.data_dir_root, x2_mvsres=cfg.mvs.x2_mvsres)
    scene = load_scene(cfg.dataset.data_dir, tuple(cfg.dataset.img_res),
                       int(scene_name[4:]), cfg.num_view, cfg.data_dir_root)
    trainer = VolTrainer(cfg, scene, scene_name, device=device,
                         exps_root=exps_root, is_continue=cfg.is_continue)
    if trainer.trains_i != trains_i:
        raise ValueError(f"training views {trainer.trains_i} != {trains_i}")
    samples = [dataset[i] for i in range(len(dataset))]
    return {"cfg": cfg, "name": scene_name, "samples": samples,
            "trainer": trainer, "trains_i": trains_i, "outdir": outdir,
            "outs_samples": [None] * len(samples),
            "extras": [None] * len(samples),
            "stage_seconds": [], "stage_peak_bytes": [],
            "feedback_seconds": [], "feedback_launches": []}


def _view_group(cfg: Config, n_views: int):
    """The node's ranks when they run a stage one reference view a rank
    (rank v of the node view v), or None for the serial loop
    (counterpart of the JAX package's `_view_mesh`): gated by
    parallel.shard_mvs_views (None follows shard_eval) and more than one
    view, and it needs a rank a view: a partial split would change what
    each card holds, which the cascade is sized for. With fewer ranks
    than views it logs a warning and the stage runs serially on every
    rank."""
    on = cfg.parallel.shard_mvs_views
    if on is None:
        on = cfg.parallel.shard_eval
    group = node_group()
    if not on or n_views <= 1 or group is None:
        return None
    if group.size < n_views:
        logger.warning(f"parallel.shard_mvs_views: {group.size} ranks for "
                       f"{n_views} views; the cascade runs serially")
        return None
    return group


def run_mvs_stage(cfg: Config, engine: MVSEngine, sc: Dict,
                  stage_idx: int) -> Tuple[List[Dict], List]:
    """One cascade stage over a scene's reference views; returns each
    view's outputs and its `extra` for the next stage. The 2D maps
    (depth, photometric_confidence) come back to the host; the volumes
    (prob_volume, depth_values) and the extras stay on the device. With
    a `_view_group`, rank v runs view v and broadcasts its outputs and
    extra to every rank of the node.

    Records the stage's seconds in sc["stage_seconds"] and, on a CUDA
    device, its peak allocated bytes in sc["stage_peak_bytes"] (this
    resets the device's peak-memory counter)."""
    samples, outs_samples = sc["samples"], sc["outs_samples"]
    dev = engine.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if "feat_cache" not in sc:
        imgs_all = np.stack([s.imgs[0] for s in samples])
        sc["feat_cache"] = engine.scene_feature_cache(imgs_all)
    inv = cfg.inverse_depth and stage_idx == 0
    hws = {tuple(s.imgs.shape[1:3]) for s in samples}
    group = _view_group(cfg, len(samples)) if len(hws) == 1 else None
    outs: List[Dict] = []
    extras: List = []
    for i, s in enumerate(samples):
        if group is not None and group.index != i:
            outs.append(None)
            extras.append(None)
            continue
        feats = engine.sample_features(
            sc["feat_cache"], [sc["trains_i"].index(v) for v in s.view_ids])
        prev_depth = None
        if stage_idx > 0 and outs_samples[i] is not None:
            prev_depth = outs_samples[i]["depth"]
        out, extra = engine.stage(
            stage_idx, feats, s.proj_matrices[f"stage{stage_idx + 1}"],
            s.depth_values, prev_depth, sc["extras"][i],
            (s.imgs.shape[1], s.imgs.shape[2]), inverse_depth=inv)
        outs.append(out)
        extras.append(extra)
    if group is not None:
        for i in range(len(samples)):
            outs[i], extras[i] = group.share((outs[i], extras[i]), i)
    # Fetch the 2D maps only after every view's stage is queued; the
    # fetch is also the device sync for the stage's time.
    for out in outs:
        for k in ("depth", "photometric_confidence"):
            out[k] = out[k].cpu().numpy()
        out[f"stage{stage_idx + 1}_confidence"] = \
            out["photometric_confidence"]
    sc["stage_seconds"].append(time.perf_counter() - t0)
    if dev.type == "cuda":
        sc["stage_peak_bytes"].append(torch.cuda.max_memory_allocated(dev))
    logger.info(f"{sc['name']} stage {stage_idx}: cost volumes in "
                f"{sc['stage_seconds'][-1]:.1f}s")
    return outs, extras


def feedback_depths(sc: Dict, outs: List[Dict]) -> None:
    """Render VolSDF depth per training view, resize it (bilinear) to
    the view's MVS resolution and overwrite the cascade depth. Records
    each render's seconds in sc["feedback_seconds"] and its fused-SDF
    kernel launches (0 on the CPU) in sc["feedback_launches"]."""
    trainer, samples = sc["trainer"], sc["samples"]
    for i, vid in enumerate(sc["trains_i"]):
        t0 = time.perf_counter()
        launches = fused_sdf_values.launches
        depth = trainer.render_mvs(vid)       # returns on the host
        sc["feedback_seconds"].append(time.perf_counter() - t0)
        sc["feedback_launches"].append(fused_sdf_values.launches - launches)
        Hm, Wm = samples[i].imgs.shape[1:3]
        d = torch.as_tensor(depth, device=trainer.device)[None, None]
        outs[i]["depth"] = B.interpolate_bilinear(
            d, (Hm, Wm))[0, 0].cpu().numpy()


def accumulate_stage(sc: Dict, outs: List[Dict], extras: List,
                     stage_idx: int) -> None:
    for i in range(len(sc["samples"])):
        if sc["outs_samples"][i] is None:
            sc["outs_samples"][i] = {}
        sc["outs_samples"][i].update(outs[i])
        sc["outs_samples"][i][f"stage{stage_idx + 1}"] = outs[i]
        sc["extras"][i] = extras[i]


def save_scene_depth(cfg: Config, scene_name: str, *,
                     mvs_weights: Optional[str] = None,
                     exps_root: str = ".",
                     engine: Optional[MVSEngine] = None,
                     device=None) -> Dict:
    """Run the interleaved 3-stage MVS/VolSDF pipeline for one scene and
    save its outputs under cfg.outdir (`save_scene_outputs`). Pass
    either a shared `engine` (when looping scenes) or the `device` to
    build one on (default "cuda"; without a CUDA device this raises
    rather than run on the CPU, which takes device="cpu"); the trainer
    runs on the engine's device. Returns the trainer, the output
    directory, the epoch counter, the MVS samples, every view's
    per-stage outputs ("outs"), the stage, peak-memory and
    feedback-render records and the seconds of writing the outputs."""
    if engine is None:
        engine = MVSEngine(cfg, weights_path=mvs_weights,
                           device=resolve_device(device, "save_scene_depth"))
    elif device is not None:
        raise ValueError("pass an engine or a device, not both: the "
                         "trainer runs on the engine's device")
    sc = setup_scene(cfg, scene_name, exps_root=exps_root,
                     device=engine.device)
    trainer = sc["trainer"]
    epoch = 0
    for stage_idx in range(3):
        outs, extras = run_mvs_stage(cfg, engine, sc, stage_idx)
        do_volopt = (not cfg.ablate
                     and cfg.opt_stepNs[stage_idx] > 0
                     and cfg.use_nerf_d[stage_idx] > 0)
        if do_volopt:
            trainer.stg = stage_idx
            trainer.get_mvs_input(outs)
            # > 1, not > 0: a budget of 1 hands the volumes over and
            # renders the feedback depth without a step.
            if cfg.opt_stepNs[stage_idx] > 1:
                epoch = trainer.run(cfg.opt_stepNs[stage_idx])
            logger.info("rendering VolSDF depth for cascade feedback")
            feedback_depths(sc, outs)
        accumulate_stage(sc, outs, extras, stage_idx)

    t0 = time.perf_counter()
    if is_writer():
        save_scene_outputs(sc)
    outputs_seconds = time.perf_counter() - t0
    logger.info(f"scene {scene_name}: outputs saved to {sc['outdir']}")
    return {"trainer": trainer, "outdir": sc["outdir"], "epoch": epoch,
            "samples": sc["samples"], "outs": sc["outs_samples"],
            "outputs_seconds": outputs_seconds,
            **{k: sc[k] for k in ("stage_seconds", "stage_peak_bytes",
                                  "feedback_seconds", "feedback_launches")}}


def save_scene_outputs(sc: Dict) -> None:
    """Write each view's depth_est and confidence PFMs (the confidence is
    the product of the three stages' maps, each resized bilinearly to
    the final resolution), their PNG visualisations (JET depth between
    the 1st depth percentile and the largest hypothesis; grey
    confidence), its cams/*_cam.txt and images/*.png, the reference
    image at MVS resolution. The JAX package writes that copy as a
    JPEG; the port writes the exact 8-bit pixels losslessly."""
    outdir = sc["outdir"]
    for s, outputs in zip(sc["samples"], sc["outs_samples"]):
        depth_est = np.asarray(outputs["depth"], np.float32)
        H, W = depth_est.shape
        conf_final = None
        for k in ("stage1", "stage2", "stage3"):
            c = torch.as_tensor(outputs[k]["photometric_confidence"])
            if tuple(c.shape) != (H, W):
                c = B.interpolate_bilinear(c[None, None], (H, W))[0, 0]
            conf_final = c if conf_final is None else conf_final * c
        conf_final = conf_final.numpy().astype(np.float32)
        save_pfm(os.path.join(outdir, s.filename.format("depth_est", ".pfm")),
                 depth_est)
        save_pfm(os.path.join(outdir,
                              s.filename.format("confidence", ".pfm")),
                 conf_final)
        # BGR like cv2's; cv2.imwrite stores it as RGB. zlib level 1 is
        # cv2's default PNG compression.
        dep_max = float(np.asarray(s.depth_values).max())
        dmin = float(np.quantile(depth_est, 0.01))
        write_png(os.path.join(outdir, s.filename.format("depth_est", ".png")),
                  visualize_depth(depth_est, depth_min=dmin,
                                  depth_max=dep_max)[..., ::-1], level=1)
        write_png(os.path.join(outdir,
                               s.filename.format("confidence", "_final.png")),
                  visualize_depth(conf_final, direct=True), level=1)
        cam = np.asarray(s.proj_matrices["stage3"][0])
        write_cam(os.path.join(outdir, s.filename.format("cams", "_cam.txt")),
                  cam, s.cam_near_far)
        img = (np.clip(s.imgs[0], 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(outdir, s.filename.format("images", ".png")),
                  img, level=1)


def _fuse_scene_task(task) -> str:
    """One scene's fusion (module level: the host pool pickles it)."""
    (scan_dir, ply, trains_i, conf, thres_view, filter_dist, filter_diff,
     eval_mask_dir, device) = task
    return filter_depth(
        scan_dir, scan_dir, ply, trains_i, conf_thresh=conf,
        thres_view=thres_view, filter_dist=filter_dist,
        filter_diff=filter_diff, eval_mask_dir=eval_mask_dir,
        device=torch.device(device))


def pcd_filter(cfg: Config, testlist: List[str], exps_root: str = ".", *,
               device=None) -> List[str]:
    """Fuse each scene's depth maps into <outdir>/mvsnet{id:03d}_l3.ply
    (counterpart of s_volsdf_tpu/engine/runner.py:574-601), with the
    eval masks of <data_dir_root>/<data_dir>/eval_mask/<scan> when
    cfg.filter.eval_mask and that directory exists. Returns the PLY
    paths of this node's scenes (`partition_scenes`).

    Fusion runs on `device` ("cuda" by default), over `cfg.num_worker`
    spawned processes when there are several scenes, each with its own
    CUDA context on this rank's card (`map_scenes_host_pool`; serially
    in this process otherwise). Under a process group the node's first
    rank fuses and the others return the paths."""
    dev = resolve_device(device, "pcd_filter")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    outdir = os.path.join(exps_root, cfg.outdir)
    tasks = []
    for scan in partition_scenes(testlist):
        trains_i = get_trains_ids(cfg.dataset.data_dir, scan, cfg.num_view)
        ply = os.path.join(outdir, f"mvsnet{int(scan[4:]):03d}_l3.ply")
        eval_mask_dir = None
        if cfg.filter.eval_mask:
            d = os.path.join(cfg.data_dir_root, cfg.dataset.data_dir,
                             "eval_mask", scan)
            eval_mask_dir = d if os.path.isdir(d) else None
        tasks.append((os.path.join(outdir, scan), ply, trains_i,
                      cfg.filter.conf, cfg.filter.thres_view,
                      cfg.filter.filter_dist, cfg.filter.filter_diff,
                      eval_mask_dir, str(dev)))
    if not is_writer():
        return [t[1] for t in tasks]
    return map_scenes_host_pool(_fuse_scene_task, tasks,
                                num_workers=cfg.num_worker)


def save_depth(cfg: Config, testlist: List[str], *,
               mvs_weights: Optional[str] = None, exps_root: str = ".",
               device=None) -> None:
    """Every scene of `testlist` that this node owns (`partition_scenes`)
    with its per-scan overrides, sharing one MVSEngine (the overrides
    never touch cfg.mvs), on `device` ("cuda" by default; without a CUDA
    device this raises rather than run on the CPU, which takes
    device="cpu")."""
    dev = resolve_device(device, "save_depth")
    testlist = partition_scenes(testlist)
    if not testlist:
        return
    engine = MVSEngine(cfg, weights_path=mvs_weights, device=dev)
    for scene in testlist:
        scene_cfg = per_scene_overrides(cfg, scene)
        logger.info(
            f"{scene}: sparse_weight={scene_cfg.loss.sparse_weight} "
            f"inverse_depth={scene_cfg.inverse_depth}")
        save_scene_depth(scene_cfg, scene, mvs_weights=mvs_weights,
                         exps_root=exps_root, engine=engine)
