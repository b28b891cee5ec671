"""The PyTorch port's configuration and synthetic data against the JAX
package's, plus the small-size setup the other tests/test_torch_*.py
files share (they import it from here).

The port carries its own copy of the config dataclasses and of the
synthetic scene generator (importing `s_volsdf_tpu` imports JAX); these
tests hold the copies equal: every default field-for-field, every
generated array bit-for-bit.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s_volsdf_tpu import config as jconfig  # noqa: E402
from s_volsdf_tpu.data import synthetic as jsynth  # noqa: E402
from s_volsdf_tpu.models.network import init_volsdf_params  # noqa: E402
from s_volsdf_tpu.ops.cost_mapping import MVSVolumes as JMVSVolumes  # noqa: E402
from s_volsdf_tpu_torch import config as tconfig  # noqa: E402
from s_volsdf_tpu_torch.bridge import from_jax_params  # noqa: E402
from s_volsdf_tpu_torch.data import synthetic as tsynth  # noqa: E402
from s_volsdf_tpu_torch.ops.cost_mapping import MVSVolumes as TMVSVolumes  # noqa: E402

N_RAYS = 16
IMG_RES = (24, 32)
VOL = (16, 12, 16)   # D, Hc, Wc


def shrink(cfg):
    """The small size of the port's CPU tests, applied to either config
    tree (the two share field names): SDF (32,)*4 with skip at 2 and
    multires 4, radiance (32, 32), feature 32, sampler 24/16/4, 16 rays,
    and the four knobs whose JAX default is bf16 (three training ones,
    the cascade's) at float32, for the float32 comparisons."""
    imp = cfg.model.implicit
    imp.dims, imp.skip_in, imp.multires = (32,) * 4, (2,), 4
    cfg.model.rendering.dims = (32, 32)
    cfg.model.feature_vector_size = 32
    s = cfg.model.sampler
    s.N_samples_eval, s.N_samples, s.N_samples_extra = 24, 16, 4
    cfg.train.num_pixels = N_RAYS
    cfg.train.train_compute_dtype = "float32"
    cfg.train.train_activation_dtype = "float32"
    cfg.train.mvs_pack_dtype = "float32"
    cfg.mvs.compute_dtype = "float32"
    return cfg


def small_configs():
    """(JAX Config, port Config) at the small size."""
    return shrink(jconfig.dtu_config()), shrink(tconfig.dtu_config())


# Two SDF MLPs outside the fused kernel's family (`fused_sdf.supported`):
# a hidden width past its 256, and two skip junctions. The port's
# sampler sweeps them with its plain MLP, as the JAX package does.
OUTSIDE_FAMILY = {"width320": ((320,) * 4, (2,)),
                  "skip24": ((32,) * 4, (2, 4))}


def outside_configs(name):
    """(JAX Config, port Config) at the small size with the SDF MLP of
    OUTSIDE_FAMILY[name]."""
    dims, skip_in = OUTSIDE_FAMILY[name]
    cfgs = small_configs()
    for cfg in cfgs:
        cfg.model.implicit.dims, cfg.model.implicit.skip_in = dims, skip_in
    return cfgs


def shrink_bmvs(cfg):
    """The small size of the BlendedMVS tests, on a bmvs preset tree
    (either package's): `shrink`, then 48-wide MLPs as in the JAX
    package's own background tests (SDF (48,)*4 with skip at 2 and
    multires 6; radiance (48, 48); features 48; the background colour
    MLP (48,)), the background SDF (96,)*4 with skip at 2 and the
    preset's multires 10 (a skip needs the width past the 84 inputs of
    the 4-D encoding), 8 inverse-sphere samples."""
    shrink(cfg)
    m = cfg.model
    m.implicit.dims, m.implicit.multires = (48,) * 4, 6
    m.rendering.dims = (48, 48)
    m.feature_vector_size = 48
    m.bg.implicit.dims, m.bg.implicit.skip_in = (96,) * 4, (2,)
    m.bg.feature_vector_size = 48
    m.bg.rendering.dims = (48,)
    m.sampler.N_samples_inverse_sphere = 8
    cfg.mvs.interval_scale = 1.0
    return cfg


def small_bmvs_configs():
    """(JAX Config, port Config) of the bmvs preset at the small size."""
    return shrink_bmvs(jconfig.bmvs_config()), shrink_bmvs(tconfig.bmvs_config())


def bg_params_pair(jcfg, seed=0):
    """JAX background-model parameters from a PRNGKey and the same values
    in the port (a VolSDFBGParams)."""
    from s_volsdf_tpu.models.network_bg import init_volsdf_bg_params
    jp = init_volsdf_bg_params(jax.random.PRNGKey(seed), jcfg.model)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def bg_step_draws(key, n_rays, scfg):
    """The random draws of one JAX training render with the background
    model at fast=1 (`render_rays_bg` with `key`), derived in its split
    order: key -> (k_sample, k_eik); k_sample -> (k_uniform, k_final,
    k_extra, k_eik, k_bg) in `error_bound_sample`. Returns (the JAX
    sampler's jitter feed, the port's jitter feed: the same draws plus
    "t_rand_bg" and the eikonal points' U[0,1) "eik_pts")."""
    k_sample, k_eik_pts = jax.random.split(key)
    k_uniform, k_final, k_extra, k_eik, k_bg = jax.random.split(k_sample, 5)
    n_final = scfg.N_samples + 2 + scfg.N_samples_extra
    jfeed = {
        "t_rand": jax.random.uniform(k_uniform, (n_rays, scfg.N_samples_eval),
                                     dtype=jnp.float32),
        "u_final": jax.random.uniform(k_final, (n_rays, scfg.N_samples)),
        "extra_idx": jax.random.permutation(
            k_extra, scfg.N_samples_eval)[: scfg.N_samples_extra],
        "eik_idx": jax.random.randint(k_eik, (n_rays, 1), 0, n_final),
    }
    extra = {
        "t_rand_bg": jax.random.uniform(
            k_bg, (n_rays, scfg.N_samples_inverse_sphere), dtype=jnp.float32),
        "eik_pts": jax.random.uniform(k_eik_pts, (n_rays, 3)),
    }
    tfeed = {k: torch.tensor(np.asarray(v))
             for k, v in {**jfeed, **extra}.items()}
    return jfeed, tfeed


def lively_mvs_tree(tree, rng, gain=6 ** 0.5, offset_gain=4.0):
    """A JAX MVS pytree (numpy leaves) made lively for the comparisons:
    random BN statistics and LayerNorm affines; every conv kernel (ndim
    >= 4) and DCN weight times `gain` (He's gain for the uniform init, so
    that features keep their size and the probabilities are not
    uniform); the DCNs' offset convs (zero at init, which makes a DCN a
    plain conv) uniform in +-offset_gain / sqrt(fan_in), their biases
    normal(0, 0.5): offsets of a few pixels, masks away from 0.5."""
    if isinstance(tree, list):
        return [lively_mvs_tree(t, rng, gain, offset_gain) for t in tree]
    if "mean" in tree:
        c = tree["scale"].shape[0]
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.normal(0, 0.1, c).astype(np.float32),
                "mean": rng.normal(0, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    if set(tree) == {"scale", "bias"}:
        c = tree["scale"].shape[0]
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = lively_mvs_tree(v, rng, gain, offset_gain)
        elif k == "w" and (np.ndim(v) >= 4 or "offset_conv" in tree):
            out[k] = (np.asarray(v) * np.float32(gain)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    if "offset_conv" in tree:
        w = out["offset_conv"]["w"]
        bound = offset_gain / np.sqrt(np.prod(w.shape[:3]))
        out["offset_conv"] = {
            "w": rng.uniform(-bound, bound, w.shape).astype(np.float32),
            "b": rng.normal(0, 0.5, w.shape[-1]).astype(np.float32)}
    return out


def params_pair(jcfg, seed=0):
    """JAX parameters from a PRNGKey and the same values in the port."""
    jp = init_volsdf_params(jax.random.PRNGKey(seed), jcfg.model)
    np_params = jax.tree.map(np.asarray, jp)
    return jp, from_jax_params(np_params)


def scene_and_volumes(inverse_depth=False, seed=7, n_views=3):
    """A 24x32 sphere scene and V=n_views informative volumes (D=16,
    12x16), as numpy: (scene, prob (V,D,Hc,Wc), z_slab (V,2,Hc,Wc))."""
    scene = jsynth.make_sphere_scene(n_views, IMG_RES)
    D, Hc, Wc = VOL
    H, W = IMG_RES
    dvals = np.linspace(0.5, 5.0, D).astype(np.float32)
    rng = np.random.default_rng(seed)
    probs, hyps = [], []
    for v in range(n_views):
        Kc = scene.intrinsics[v].copy()
        Kc[0, :] *= Wc / W
        Kc[1, :] *= Hc / H
        prob, hyp = jsynth.gt_prob_volume(
            scene.poses[v], Kc, (Hc, Wc), dvals, scale_factor=1.0,
            sigma_intervals=1.0, floor=0.02, inverse_depth=inverse_depth,
            depth_noise=0.01, rng=rng)
        probs.append(prob)
        hyps.append(hyp)
    prob = np.stack(probs)
    near, far = hyps[0][0], hyps[0][-1]
    z_slab = np.stack([np.full((n_views, Hc, Wc), near, np.float32),
                       np.full((n_views, Hc, Wc), far, np.float32)], axis=1)
    # A ragged slab edge: some pixels with degenerate near/far.
    z_slab[:, :, :2, :3] = 0.0
    return scene, prob, z_slab


def mvs_pair(scene, prob, z_slab, inverse_depth=False):
    """The same f32 volumes as JAX MVSVolumes and port MVSVolumes."""
    jm = JMVSVolumes(prob=jnp.asarray(prob), z_slab=jnp.asarray(z_slab),
                     intrinsics=jnp.asarray(scene.intrinsics),
                     c2w=jnp.asarray(scene.poses), img_res=scene.img_res,
                     inverse_depth=inverse_depth)
    tm = TMVSVolumes(prob=torch.tensor(prob), z_slab=torch.tensor(z_slab),
                     intrinsics=torch.tensor(scene.intrinsics),
                     c2w=torch.tensor(scene.poses), img_res=scene.img_res,
                     inverse_depth=inverse_depth)
    return jm, tm


def torch_jitter(feed, n_extra):
    """The port's counterpart of tools/paired_jitter.jitter_batch_entry."""
    return {
        "t_rand": torch.tensor(feed["t_rand"]),
        "u_final": torch.tensor(feed["u_final"]),
        "extra_idx": torch.tensor(feed["extra_perm"][:n_extra]),
        "eik_idx": torch.tensor(feed["eik_idx"][:, None]),
        "eik_pts": torch.tensor(feed["eik_pts"]),
    }


def _port_fields(port_dc, jax_dc, path=""):
    """(path, port value, JAX value) for every field of the port's
    dataclass, recursing into nested config dataclasses."""
    for f in dataclasses.fields(port_dc):
        pv, jv = getattr(port_dc, f.name), getattr(jax_dc, f.name)
        if dataclasses.is_dataclass(pv):
            yield from _port_fields(pv, jv, f"{path}{f.name}.")
        else:
            yield f"{path}{f.name}", pv, jv


def test_config_defaults_match_jax():
    """Every field the port's dtu preset carries has the JAX default."""
    pairs = list(_port_fields(tconfig.dtu_config(), jconfig.dtu_config()))
    assert len(pairs) > 40
    diff = [(p, a, b) for p, a, b in pairs if a != b]
    assert not diff, diff


def test_bmvs_config_matches_jax():
    """Every field of the port's bmvs preset, the background networks
    (model.bg), N_samples_inverse_sphere and the gate-rescue knobs
    included, has the JAX preset's value."""
    pairs = list(_port_fields(tconfig.bmvs_config(), jconfig.bmvs_config()))
    names = {p for p, _, _ in pairs}
    assert {"model.bg.implicit.multires", "model.bg.rendering.mode",
            "model.sampler.N_samples_inverse_sphere",
            "loss.gate_rescue_weight", "loss.gate_rescue_peak"} <= names
    diff = [(p, a, b) for p, a, b in pairs if a != b]
    assert not diff, diff
    cfg = tconfig.bmvs_config()
    assert cfg.model.sampler.N_samples_inverse_sphere == 32
    assert cfg.model.bg.implicit.weight_norm is False
    tconfig.check_ported(cfg)


@pytest.mark.parametrize("section,name", tconfig.PRECISION_KNOBS)
def test_precision_knobs_validated(section, name):
    """Each precision knob takes the JAX package's values ("float32",
    "bfloat16"), and `check_ported` raises on any other, as the JAX
    validate_config asserts."""
    _, cfg = small_configs()
    for value in ("float32", "bfloat16"):
        setattr(getattr(cfg, section), name, value)
        tconfig.check_ported(cfg)
    setattr(getattr(cfg, section), name, "float16")
    with pytest.raises(ValueError, match=f"{section}.{name}"):
        tconfig.check_ported(cfg)


def test_mvs_model_names_validated():
    """The three cascades pass `check_mvs_ported`; another name raises
    ValueError, as the JAX engine raises for it."""
    _, cfg = small_configs()
    for name in tconfig.MVS_MODELS:
        cfg.mvs.model_name = name
        tconfig.check_mvs_ported(cfg.mvs)
    assert tconfig.MVS_MODELS == ("casmvsnet", "ucsnet", "transmvsnet")
    cfg.mvs.model_name = "mvsnet"
    with pytest.raises(ValueError, match="mvs.model_name"):
        tconfig.check_mvs_ported(cfg.mvs)


@pytest.mark.parametrize("section", ["mvs", "dataset", "filter", "plot"])
def test_new_sections_match_jax(section):
    """The cascade's, the dataset's, fusion's and mesh export's
    dataclasses carry every field of their JAX counterparts, with the
    same defaults."""
    t = getattr(tconfig.Config(), section)
    j = getattr(jconfig.Config(), section)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_runner_fields_match_jax():
    names = ("num_view", "testlist", "outdir", "exps_folder",
             "data_dir_root", "opt_stepNs", "use_nerf_d", "inverse_depth",
             "ablate")
    t, j = tconfig.dtu_config(), jconfig.dtu_config()
    assert [getattr(t, n) for n in names] == [getattr(j, n) for n in names]


@pytest.mark.parametrize("scene", ["scan24", "scan37", "scan106"])
@pytest.mark.parametrize("data_dir", ["DTU", "BlendedMVS"])
def test_per_scene_overrides_match_jax(scene, data_dir):
    t, j = tconfig.dtu_config(), jconfig.dtu_config()
    t.dataset.data_dir = j.dataset.data_dir = data_dir
    for s in (scene, "scan2", "scan5"):
        a = tconfig.per_scene_overrides(t, s)
        b = jconfig.per_scene_overrides(j, s)
        assert a.loss.sparse_weight == b.loss.sparse_weight
        assert a.inverse_depth == b.inverse_depth
    assert t.loss.sparse_weight == 1.0 and not t.inverse_depth


@pytest.mark.parametrize("field,value", [
    ("mvs.numdepth", 96), ("mvs.ndepths", (192, 32, 4)),
    ("opt_stepNs", (1, 0)), ("max_h", 512), ("dataset.data_dir", "ETH3D")])
def test_validate_config_raises(field, value):
    """The invariants the cascade relies on; the JAX asserts hold the
    same configs invalid."""
    for mod in (tconfig, jconfig):
        cfg = mod.dtu_config()
        section, _, name = field.rpartition(".")
        setattr(getattr(cfg, section) if section else cfg, name, value)
        with pytest.raises((ValueError, AssertionError)):
            mod.validate_config(cfg)
    tconfig.validate_config(tconfig.dtu_config())


def test_sphere_scene_bit_equal():
    a = jsynth.make_sphere_scene(3, (20, 28))
    b = tsynth.make_sphere_scene(3, (20, 28))
    for name in ("intrinsics", "poses", "images", "depths"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.img_res == b.img_res


@pytest.mark.parametrize("inverse_depth", [False, True])
def test_gt_prob_volume_bit_equal(inverse_depth):
    scene = jsynth.make_sphere_scene(2, (20, 28))
    dvals = np.linspace(0.5, 5.0, 12).astype(np.float32)
    args = (scene.poses[1], scene.intrinsics[1], (20, 28), dvals, 1.0)
    kw = dict(sigma_intervals=1.0, floor=0.02, inverse_depth=inverse_depth,
              depth_noise=0.01)
    pa, ha = jsynth.gt_prob_volume(*args, rng=np.random.default_rng(3), **kw)
    pb, hb = tsynth.gt_prob_volume(*args, rng=np.random.default_rng(3), **kw)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ha, hb)


def test_sphere_radial_error_bit_equal():
    scene = jsynth.make_sphere_scene(2, (20, 28))
    rng = np.random.default_rng(5)
    for v in range(2):
        depth = (np.where(np.isfinite(scene.depths[v]), scene.depths[v], 3.0)
                 * 200.0 + rng.normal(0, 0.5, (20, 28))).astype(np.float32)
        args = (scene.poses[v], scene.intrinsics[v], (20, 28), depth, 200.0)
        want = jsynth.sphere_radial_error(*args)
        got = tsynth.sphere_radial_error(*args)
        assert got == want and want[2] > 0
        assert all(type(a) is type(b) for a, b in zip(got, want))


def test_sample_rays_bit_equal():
    scene = jsynth.make_sphere_scene(3, (20, 28))
    for v in range(3):
        uv_a, rgb_a = jsynth.sample_rays(scene, np.random.default_rng(v), v, 37)
        uv_b, rgb_b = tsynth.sample_rays(scene, np.random.default_rng(v), v, 37)
        for a, b in ((uv_a, uv_b), (rgb_a, rgb_b)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
