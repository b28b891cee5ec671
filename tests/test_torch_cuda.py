"""The port's CUDA kernels against their plain PyTorch versions, the
three MVS cascades on the card against the same cascades on the CPU, and
fusion on the card against fusion on the CPU. No TF32 flag is set here:
the port's entry points keep their float32 work out of TF32 themselves.

Every test here needs an NVIDIA GPU (and nvcc for the kernel); without
one it skips with the reason. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports no JAX (the card's machine need not have it).
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from s_volsdf_tpu_torch import config as tconfig  # noqa: E402
from s_volsdf_tpu_torch.models.network import (init_volsdf_params,  # noqa: E402
                                               stack_params)
from s_volsdf_tpu_torch.engine.render import render_depth  # noqa: E402
from s_volsdf_tpu_torch.engine import fusion  # noqa: E402
from s_volsdf_tpu_torch.data.synthetic import make_sphere_scene  # noqa: E402
from s_volsdf_tpu_torch.ops import (cost_mapping, deform_conv,  # noqa: E402
                                    fused_sdf, geo_consistency)

pytestmark = pytest.mark.cuda

# The bfloat16 mode's bar against its plain bf16 version, (|sdf| + 1)
# units: 2^-7 (the worst measured on an H100 is 3.2e-3).
BF16_KERNEL_UNITS = chip_smoke.BF16_KERNEL_UNITS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [700, 65536, 65537, 2097152])
def test_kernel_matches_plain(cuda, n):
    """Full dtu width, up to one render launch (16,384 rays x 128) and
    with a ragged last block. Tolerance 1e-4: the kernel's bf16 x 3
    split (about 2^-16 of each product) and float32 sums in another
    order across 9 layers."""
    cfg = tconfig.dtu_config()
    params = init_volsdf_params(torch.Generator().manual_seed(0), cfg.model,
                                cuda)
    pts = torch.tensor(np.random.default_rng(1).normal(size=(n, 3)),
                       dtype=torch.float32, device=cuda)
    before = fused_sdf.fused_sdf_values.launches
    got = fused_sdf.fused_sdf_values(params.sdf, cfg.model, pts, 3.0)
    torch.cuda.synchronize()
    assert fused_sdf.fused_sdf_values.launches == before + 1
    ref = fused_sdf.sdf_values_plain(params.sdf, cfg.model, pts, 3.0)
    assert got.shape == (n,)
    assert torch.max(torch.abs(got - ref)).item() <= 1e-4


@pytest.mark.parametrize("dims,skip_in,multires,bounding_sphere", [
    ((32,) * 4, (2,), 4, 3.0),      # the CPU tests' small size
    ((64,) * 3, (), 2, 0.0),        # no skip junction, no clamp
    ((102,) * 5, (3,), 10, 3.0),    # widths that are not multiples of 4
    ((64,) * 3, (3,), 4, 3.0),      # the skip junction feeds the SDF layer
])
def test_kernel_family_matches_plain(cuda, dims, skip_in, multires,
                                     bounding_sphere):
    """Other members of the family `supported` names: the padding of
    odd widths, the skip junction's placement, the clamp switched off."""
    cfg = tconfig.dtu_config()
    imp = cfg.model.implicit
    imp.dims, imp.skip_in, imp.multires = dims, skip_in, multires
    cfg.model.feature_vector_size = 16
    assert fused_sdf.supported(cfg.model)
    params = init_volsdf_params(torch.Generator().manual_seed(1), cfg.model,
                                cuda)
    pts = torch.tensor(np.random.default_rng(2).normal(size=(1000, 3)),
                       dtype=torch.float32, device=cuda)
    got = fused_sdf.fused_sdf_values(params.sdf, cfg.model, pts,
                                     bounding_sphere)
    ref = fused_sdf.sdf_values_plain(params.sdf, cfg.model, pts,
                                     bounding_sphere)
    assert torch.max(torch.abs(got - ref)).item() <= 1e-4


@pytest.mark.parametrize("activation", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims,skip_in,multires,bounding_sphere,n", [
    ((256,) * 8, (4,), 6, 3.0, 700),
    ((256,) * 8, (4,), 6, 3.0, 65537),
    ((256,) * 8, (4,), 6, 3.0, 2097152),
    ((32,) * 4, (2,), 4, 3.0, 1000),
    ((64,) * 3, (), 2, 0.0, 1000),
    ((102,) * 5, (3,), 10, 3.0, 1000),
    ((64,) * 3, (3,), 4, 3.0, 1000),
])
def test_bf16_kernel_matches_plain(cuda, dims, skip_in, multires,
                                   bounding_sphere, n, activation):
    """The bfloat16 mode against its plain bf16 version, in the working
    type: within 2^-7 (|sdf| + 1) (chip_smoke.BF16_KERNEL_UNITS: wgmma's
    order of summation moves a bf16 rounding of an activation now and
    then; measured up to 3.2e-3). One launch, counted in its mode."""
    cfg = tconfig.dtu_config()
    imp = cfg.model.implicit
    imp.dims, imp.skip_in, imp.multires = dims, skip_in, multires
    if dims[0] != 256:
        cfg.model.feature_vector_size = 16
    mcfg = dataclasses.replace(cfg.model, compute_dtype="bfloat16",
                               activation_dtype=activation)
    params = init_volsdf_params(torch.Generator().manual_seed(0), cfg.model,
                                cuda)
    pts = torch.tensor(np.random.default_rng(1).normal(size=(n, 3)),
                       dtype=torch.float32, device=cuda)
    before = dict(fused_sdf.fused_sdf_values.mode_launches)
    got = fused_sdf.fused_sdf_values(params.sdf, mcfg, pts, bounding_sphere)
    torch.cuda.synchronize()
    assert fused_sdf.fused_sdf_values.mode_launches["bfloat16"] \
        == before["bfloat16"] + 1
    ref = fused_sdf.sdf_values_plain(params.sdf, mcfg, pts, bounding_sphere)
    err = (got - ref).abs() / (ref.abs() + 1)
    assert err.max().item() <= BF16_KERNEL_UNITS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse_depth", [False, True])
def test_cost_mapping_kernel_matches_plain(cuda, dtype, inverse_depth):
    """The cost-mapping kernel against its plain version on the card at
    bench.py's shapes (512 x 96 samples, three 192x288x384 volumes):
    masks equal, pj and pi bit-equal (chip_smoke.COST_TOL is 0: the same
    operations in the same order, --fmad=false). One launch, on the
    volumes' kernel copy; volumes without one raise and launch nothing."""
    scene = make_sphere_scene(3, chip_smoke.CASCADE_RES)
    mvs = chip_smoke.make_volumes(scene, chip_smoke.BENCH_VOLUMES, cuda)
    mvs = dataclasses.replace(mvs, prob=mvs.prob.to(dtype),
                              inverse_depth=inverse_depth)
    xyz = chip_smoke.cost_mapping_samples(scene, 1, cuda)
    onehot = torch.tensor([0.0, 1.0, 0.0], device=cuda)
    before = cost_mapping.cost_mapping.launches
    with pytest.raises(ValueError, match="check_volumes"):
        cost_mapping.cost_mapping(None, xyz, onehot, mvs)
    mvs = cost_mapping.check_volumes(mvs)
    with pytest.raises(ValueError, match="check_volumes"):   # a stale copy
        cost_mapping.cost_mapping(None, xyz, onehot, dataclasses.replace(
            mvs, inverse_depth=not inverse_depth))
    assert cost_mapping.cost_mapping.launches == before
    got = cost_mapping.cost_mapping(None, xyz, onehot, mvs)
    torch.cuda.synchronize()
    assert cost_mapping.cost_mapping.launches == before + 1
    ref = cost_mapping.cost_mapping_plain(xyz, onehot, mvs)
    assert torch.equal(got[2], ref[2]) and 0 < int(ref[2].sum()) < ref[2].numel()
    for g, r in zip(got[:2], ref[:2]):
        assert (g - r).abs().max().item() <= chip_smoke.COST_TOL


@functools.lru_cache(maxsize=None)
def _views_and_volumes(n_views, vol_shape):
    """A sphere scene of `n_views` views and its float32 volumes, on the
    host (made once per shape)."""
    scene = make_sphere_scene(n_views, chip_smoke.CASCADE_RES)
    return scene, chip_smoke.make_volumes(scene, vol_shape, "cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse_depth", [False, True])
@pytest.mark.parametrize("n_views,vol_shape", [
    (2, chip_smoke.BENCH_VOLUMES), (4, chip_smoke.BENCH_VOLUMES),
    (33, (24, 36, 48))])     # past a warp's 32 lanes: two rounds of views
def test_cost_mapping_kernel_any_views(cuda, n_views, vol_shape, dtype,
                                       inverse_depth):
    """The cost-mapping kernel at other view counts than the main path's
    3 (the JAX package takes any number of training views): masks equal
    and pj, pi bit-equal to the plain version, which sums the views in
    the kernel's order. One launch."""
    scene, host = _views_and_volumes(n_views, vol_shape)
    mvs = cost_mapping.check_volumes(dataclasses.replace(
        host, prob=host.prob.to(cuda, dtype), z_slab=host.z_slab.to(cuda),
        intrinsics=host.intrinsics.to(cuda), c2w=host.c2w.to(cuda),
        inverse_depth=inverse_depth))
    view = n_views - 1
    xyz = chip_smoke.cost_mapping_samples(scene, view, cuda)
    onehot = torch.zeros(n_views, device=cuda)
    onehot[view] = 1.0
    before = cost_mapping.cost_mapping.launches
    got = cost_mapping.cost_mapping(None, xyz, onehot, mvs)
    torch.cuda.synchronize()
    assert cost_mapping.cost_mapping.launches == before + 1
    ref = cost_mapping.cost_mapping_plain(xyz, onehot, mvs)
    assert torch.equal(got[2], ref[2]) and 0 < int(ref[2].sum()) < ref[2].numel()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("family", sorted(chip_smoke.OUTSIDE_FAMILY))
def test_outside_family_route_on_card(cuda, family):
    """A config outside the fused kernel's family trains (two steps) and
    renders (6x8) on the card through the sampler's plain route: no
    fused-SDF launch and no weight pack, the plain sweeps rising."""
    cfg = chip_smoke.outside_family_config(
        **chip_smoke.OUTSIDE_FAMILY[family])
    trainer = chip_smoke.make_trainer(cfg, (48, 64), (16, 12, 16), cuda)
    fused_sdf.reset_launches()
    builds = fused_sdf.pack_sdf.builds
    trainer.run(2)
    torch.cuda.synchronize()
    step_sweeps = fused_sdf.plain_sweeps
    assert all(np.isfinite(lo.loss) for lo in trainer.losses)
    intr = np.array(trainer.scene.intrinsics[0], np.float32)
    intr[:2] *= 8 / 64
    maps = render_depth(trainer.state.params, cfg.model,
                        trainer.scene.poses[0], intr, (6, 8), chunk=48)
    assert np.isfinite(maps["depth"]).all()
    assert fused_sdf.fused_sdf_values.launches == 0
    assert fused_sdf.pack_sdf.builds == builds
    assert 0 < step_sweeps < fused_sdf.plain_sweeps


def test_unsupported_config_raises(cuda):
    cfg = tconfig.dtu_config()
    params = init_volsdf_params(torch.Generator().manual_seed(0), cfg.model,
                                cuda)
    cfg.model.implicit.skip_in = (2, 4)
    pts = torch.zeros((64, 3), device=cuda)
    with pytest.raises(ValueError, match="family"):
        fused_sdf.fused_sdf_values(params.sdf, cfg.model, pts, 3.0)


def test_cascade_stages_match_cpu(cuda, tmp_path):
    """The three CasMVSNet stages of one 64x96 view, D = 16/8/8, on the
    card and on the CPU with the same bridged weights, each fed the same
    previous depth. prob_volume within 1e-4, depth within 1e-5 relative
    (cuDNN's float32 convs sum in another order than the CPU's)."""
    errs = chip_smoke.cascade_card_vs_cpu(cuda, str(tmp_path / "data"))
    assert errs["prob"] <= chip_smoke.PROB_TOL, errs
    assert errs["depth_rel"] <= chip_smoke.DEPTH_RTOL, errs


@pytest.mark.parametrize("model", chip_smoke.OTHER_MODELS)
def test_other_cascades_match_cpu(cuda, tmp_path, model):
    """UCSNet's and TransMVSNet's three stages of one 64x96 view, D =
    16/8/8, float32, He-gain convs and random DCN offset convs, on the
    card and on the CPU with the same weights, each stage fed the card's
    previous depth and extra: prob_volume within 1e-4, the regressed
    depth within 1e-5 relative; TransMVSNet's winner-take-all hypothesis
    equal where the top two probabilities differ by more than 1e-4, its
    confidence within 1e-4."""
    errs = chip_smoke.cascade_card_vs_cpu(cuda, str(tmp_path / "data"), model)
    assert errs["prob"] <= chip_smoke.PROB_TOL, errs
    assert errs["depth_rel"] <= chip_smoke.DEPTH_RTOL, errs
    assert errs.get("wta", 0) == 0, errs
    assert errs.get("conf", 0.0) <= chip_smoke.PROB_TOL, errs


@pytest.mark.parametrize("head", [0, 1, 2])
def test_deform_conv_kernel_matches_plain(cuda, head):
    """The deformable-conv kernel against its plain version at the
    three DCNs of TransMVSNet's stage-`head + 1` head at x2 DTU shapes
    (Cin 32; 288x384, 576x768, 1152x1536), random offsets with a
    2-pixel spread and masks in (0, 1): within 1e-5 (1 + |plain|), one
    launch a call."""
    scale, couts = chip_smoke.DCN_HEADS[head]
    H, W = 1152 // scale, 1536 // scale
    for i, cout in enumerate(couts):
        args = chip_smoke.dcn_inputs(H, W, cout, cuda, 10 * head + i)
        before = deform_conv.deform_conv2d.launches
        got = deform_conv.deform_conv2d(*args)
        ref = deform_conv.deform_conv2d_plain(*args)
        torch.cuda.synchronize()
        assert deform_conv.deform_conv2d.launches == before + 1
        assert got.shape == (cout, H, W)
        rel = ((got - ref) / (1 + ref.abs())).abs().max().item()
        assert rel <= chip_smoke.DCN_TOL, (cout, rel)


@pytest.mark.parametrize("cout", [8, 16, 32])
def test_deform_conv_kernel_ragged_tile(cuda, cout):
    """37 x 53 pixels: the last row and column of 16 x 16 tiles are
    partial, and their windows reach past the image."""
    args = chip_smoke.dcn_inputs(37, 53, cout, cuda, cout)
    got = deform_conv.deform_conv2d(*args)
    ref = deform_conv.deform_conv2d_plain(*args)
    torch.cuda.synchronize()
    rel = ((got - ref) / (1 + ref.abs())).abs().max().item()
    assert rel <= chip_smoke.DCN_TOL, rel


def _dcn_rel(args) -> float:
    """The kernel (one launch) against the plain version: max |diff| /
    (1 + |plain|)."""
    before = deform_conv.deform_conv2d.launches
    got = deform_conv.deform_conv2d(*args)
    ref = deform_conv.deform_conv2d_plain(*args)
    torch.cuda.synchronize()
    assert deform_conv.deform_conv2d.launches == before + 1
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    return ((got - ref) / (1 + ref.abs())).abs().max().item()


def _dcn_with_offsets(H, W, cout, device, seed, offset):
    """dcn_inputs at H x W with `offset` (18, H, W) in place."""
    args = chip_smoke.dcn_inputs(H, W, cout, device, seed)
    args[1] = offset.to(device).contiguous()
    return args


@pytest.mark.parametrize("cout", [8, 16, 32])
def test_deform_conv_kernel_wide_offsets(cuda, cout):
    """Offsets with a 16-pixel spread: most samples leave their tile's
    window and read their corners from device memory."""
    H, W = 72, 100
    gen = torch.Generator().manual_seed(cout)
    offset = 16.0 * torch.randn((2 * deform_conv.TAPS, H, W), generator=gen)
    assert deform_conv.outside_window_share(offset) > 0.5
    rel = _dcn_rel(_dcn_with_offsets(H, W, cout, cuda, cout, offset))
    assert rel <= chip_smoke.DCN_TOL, rel


@pytest.mark.parametrize("cout", [8, 16, 32])
def test_deform_conv_kernel_integer_offsets(cuda, cout):
    """Whole-pixel offsets in [-4, 4]: every bilinear weight is 0 or 1,
    some samples on the window's last row and column."""
    H, W = 50, 70
    gen = torch.Generator().manual_seed(100 + cout)
    offset = torch.randint(-4, 5, (2 * deform_conv.TAPS, H, W),
                           generator=gen).float()
    rel = _dcn_rel(_dcn_with_offsets(H, W, cout, cuda, cout, offset))
    assert rel <= chip_smoke.DCN_TOL, rel


@pytest.mark.parametrize("cout", [8, 16, 32])
def test_deform_conv_kernel_edge_bands(cuda, cout):
    """Samples in (-1, 0) and (H - 1, H) (and (-1, 0), (W - 1, W)) on
    every edge, where one corner row or column lies outside the image,
    mixed with samples inside it."""
    H, W = 40, 56
    K = deform_conv.TAPS
    rng = np.random.default_rng(cout)

    def targets(n):
        band = rng.integers(0, 3, (K, H, W))
        return np.where(band == 0, rng.uniform(-1, 0, (K, H, W)),
                        np.where(band == 1, rng.uniform(n - 1, n, (K, H, W)),
                                 rng.uniform(0, n - 1, (K, H, W))))

    ky = (np.arange(K) // 3 - 1)[:, None, None]
    kx = (np.arange(K) % 3 - 1)[:, None, None]
    dy = targets(H) - (np.arange(H)[None, :, None] + ky)
    dx = targets(W) - (np.arange(W)[None, None, :] + kx)
    offset = torch.tensor(np.stack([dy, dx], 1).reshape(2 * K, H, W),
                          dtype=torch.float32)
    sy = np.arange(H)[None, :, None] + ky + dy
    assert ((sy > -1) & (sy < 0)).any() and ((sy > H - 1) & (sy < H)).any()
    rel = _dcn_rel(_dcn_with_offsets(H, W, cout, cuda, cout, offset))
    assert rel <= chip_smoke.DCN_TOL, rel


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (37, 53)])
@pytest.mark.parametrize("cout", [8, 16, 32])
def test_deform_conv_kernel_small_images(cuda, hw, cout):
    """Images smaller than one 16 x 16 tile, and one that is no multiple
    of it: pixels of the tile outside the image are neither read nor
    written."""
    rel = _dcn_rel(chip_smoke.dcn_inputs(*hw, cout, cuda, 7 * cout))
    assert rel <= chip_smoke.DCN_TOL, rel


@pytest.mark.parametrize("cout", [8, 16, 32])
def test_deform_conv_kernel_batch(cuda, cout):
    """Three views in one launch, written into one (3, Cout, H, W)
    output, each equal to its own plain deformable conv."""
    H, W = 45, 70
    views = [chip_smoke.dcn_inputs(H, W, cout, cuda, 30 + v)
             for v in range(3)]
    weight, bias = views[0][3], views[0][4]
    x, offset, mask = (torch.stack([v[i] for v in views]) for i in range(3))
    before = deform_conv.deform_conv2d.launches
    got = deform_conv.deform_conv2d_batch(x, offset, mask, weight, bias)
    torch.cuda.synchronize()
    assert deform_conv.deform_conv2d.launches == before + 1
    assert got.shape == (3, cout, H, W)
    for v in range(3):
        ref = deform_conv.deform_conv2d_plain(x[v], offset[v], mask[v],
                                              weight, bias)
        rel = ((got[v] - ref) / (1 + ref.abs())).abs().max().item()
        assert rel <= chip_smoke.DCN_TOL, (v, rel)


def test_deform_conv_refuses_what_it_does_not_take(cuda):
    """A CUDA tensor goes to the kernel or raises: other dtypes (the
    kernel is float32 only), a non-contiguous operand, a Cout outside
    8/16/32, operands on two devices."""
    args = chip_smoke.dcn_inputs(64, 96, 16, cuda, 0)
    for i in range(5):
        for dtype in (torch.float64, torch.bfloat16):
            bad = list(args)
            bad[i] = bad[i].to(dtype)
            with pytest.raises(ValueError, match="float32"):
                deform_conv.deform_conv2d(*bad)
    bad = list(args)
    bad[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        deform_conv.deform_conv2d(*bad)
    bad = chip_smoke.dcn_inputs(64, 96, 12, cuda, 0)
    with pytest.raises(ValueError, match="Cout"):
        deform_conv.deform_conv2d(*bad)
    bad = list(args)
    bad[3] = args[3].cpu()
    with pytest.raises(ValueError, match="cpu"):
        deform_conv.deform_conv2d(*bad)


def _depth_pair(H, W, angle, seed=0):
    """Two noisy depth maps of a smooth surface about 600 units away,
    5% holes, seen by float32 cameras `angle` radians apart."""
    rng = np.random.default_rng(seed)
    intr = np.array([[1.1 * W, 0, W / 2], [0, 1.1 * W, H / 2], [0, 0, 1]],
                    np.float32)

    def extr(a):
        c, s = np.cos(a), np.sin(a)
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        E[:3, 3] = [40 * a, 0, 600]
        return E

    base = (600 + 30 * np.sin(np.linspace(0, 3, W))[None]
            + 20 * np.cos(np.linspace(0, 2, H))[:, None])
    d_ref = (base + rng.standard_normal((H, W))).astype(np.float32)
    d_src = (base + rng.standard_normal((H, W))).astype(np.float32)
    d_ref[rng.random((H, W)) < 0.05] = 0
    return d_ref, intr, extr(0.0), d_src, intr, extr(angle)


@pytest.mark.parametrize("H,W,angle", [(1152, 1536, 0.1), (64, 96, 0.1),
                                       (37, 131, 0.8)])
@pytest.mark.parametrize("xy", [False, True])
def test_geo_consistency_kernel_matches_plain(cuda, H, W, angle, xy):
    """The kernel (built with --fmad=false) against its plain version on
    the card and on the CPU: masks equal, depth within 1e-12, x/y within
    1e-9 (measured equal)."""
    d_ref, K1, E1, d_src, K2, E2 = _depth_pair(H, W, angle)
    mats = geo_consistency.pair_matrices(K1, E1, K2, E2)
    a, b = torch.tensor(d_ref, device=cuda), torch.tensor(d_src, device=cuda)
    before = geo_consistency.geo_consistency.launches
    got = geo_consistency.geo_consistency(a, b, mats, 1.0, 0.01, xy=xy)
    torch.cuda.synchronize()
    assert geo_consistency.geo_consistency.launches == before + 1
    for ref in (geo_consistency.geo_consistency_plain(a, b, mats, 1.0, 0.01, xy),
                geo_consistency.geo_consistency_plain(a.cpu(), b.cpu(), mats,
                                                      1.0, 0.01, xy)):
        assert torch.equal(got[0].cpu(), ref[0].cpu())
        assert (got[1].cpu() - ref[1].cpu()).abs().max().item() <= 1e-12
        if xy:
            for g, r in zip(got[2:], ref[2:]):
                assert (g.cpu() - r.cpu()).abs().max().item() <= 1e-9
        else:
            assert got[2] is None and got[3] is None


def test_fuse_views_card_matches_cpu(cuda):
    """The whole fusion of three views on the card against the CPU:
    equal counts, xyz within one float32 ulp, rgb equal."""
    rng = np.random.default_rng(1)
    views = []
    for angle in (0.0, 0.05, -0.05):
        d, K, _, _, _, E = _depth_pair(96, 128, angle, seed=2)
        views.append({"depth": d, "confidence": rng.random(d.shape, np.float32),
                      "intrinsics": K, "extrinsics": E,
                      "image": rng.random(d.shape + (3,), np.float32)})
    got = fusion.fuse_views(views, device=cuda)
    want = fusion.fuse_views(views, device="cpu")
    assert got[0].shape == want[0].shape and got[0].shape[0] > 0
    assert np.all(np.abs(got[0] - want[0]) <= np.spacing(np.abs(want[0])))
    np.testing.assert_array_equal(got[1], want[1])


def test_eval_sdf_grid_kernel_matches_plain(cuda):
    """Mesh export's grid evaluation on the card (the fused kernel,
    float32 mode, one pack) against the plain MLP on a 32^3 grid of the
    dtu width, in 2 ragged launches: within the kernel's 1e-4 bar."""
    from s_volsdf_tpu_torch.engine import mesh
    cfg = tconfig.dtu_config()
    params = init_volsdf_params(torch.Generator().manual_seed(0), cfg.model,
                                cuda)
    bs = cfg.model.scene_bounding_sphere
    pts, _ = mesh._grid_from_bounds([-1.5] * 3, [1.5] * 3, 32)
    fused_sdf.reset_launches()
    builds = fused_sdf.pack_sdf.builds
    got = mesh.eval_sdf_grid(mesh.mesh_sdf_fn(params, cfg.model, bs), pts,
                             chunk=20000)
    assert fused_sdf.fused_sdf_values.mode_launches["float32"] == 2
    assert fused_sdf.pack_sdf.builds == builds + 1
    ref = fused_sdf.sdf_values_plain(
        params.sdf, cfg.model,
        torch.from_numpy(pts.block(0, len(pts))).to(cuda), bs)
    assert np.abs(got - ref.cpu().numpy()).max() <= chip_smoke.KERNEL_TOL


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """Two steps, save, load into a fresh trainer (is_continue): every
    leaf and the CUDA generator's state bit-equal, and two more steps on
    each give bit-equal losses and parameters."""
    from s_volsdf_tpu_torch.data.scene_dataset import scene_from_synthetic
    from s_volsdf_tpu_torch.engine.trainer import VolTrainer
    from s_volsdf_tpu_torch.utils import checkpoint as ckpt
    cfg = chip_smoke.float32_dtu_config()
    cfg.train.num_pixels = 64
    scene = scene_from_synthetic(make_sphere_scene(3, (48, 64)))

    def trainer(is_continue):
        return VolTrainer(cfg, scene, "scan106", device=cuda,
                          exps_root=str(tmp_path), is_continue=is_continue,
                          chunk_steps=1)
    a = trainer(False)
    a.run(2)
    b = trainer(True)
    for x, y in zip(ckpt.train_state_leaves(a.state),
                    ckpt.train_state_leaves(b.state)):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    a.run(2)
    b.run(2)
    assert [lo.loss for lo in a.losses] == [lo.loss for lo in b.losses]
    for x, y in zip(ckpt.train_state_leaves(a.state),
                    ckpt.train_state_leaves(b.state)):
        np.testing.assert_array_equal(x, y)


# -- image-based rendering ----------------------------------------------------

@pytest.mark.parametrize("hw", [(64, 96), (75, 33), (576, 768)])
def test_ibr_image_ops_card_match_cpu(cuda, hw):
    """utils/image.py's cv2 counterparts on the card against the CPU:
    pyr_down, pyr_up (float64, 1e-12), remap_cubic (float32 result of
    float64 sums, 1e-6, zeros equal), erode5 (equal)."""
    from s_volsdf_tpu_torch.utils import image
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.random((2,) + hw + (3,)))
    for op in (image.pyr_down, image.pyr_up):
        got, want = op(a.to(cuda)).cpu(), op(a)
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-12
    img = a[0].to(torch.float32)
    mx = torch.as_tensor(rng.uniform(-4, hw[1] + 4, hw), dtype=torch.float32)
    my = torch.as_tensor(rng.uniform(-4, hw[0] + 4, hw), dtype=torch.float32)
    mx[0, :3] = torch.tensor([float("nan"), 1e9, -1.2])
    got = image.remap_cubic(img.to(cuda), mx.to(cuda), my.to(cuda)).cpu()
    want = image.remap_cubic(img, mx, my)
    assert (got - want).abs().max().item() <= 1e-6
    assert torch.equal(got == 0, want == 0)
    m = (a > 0.2).to(torch.float64)
    assert torch.equal(image.erode5(m.to(cuda)).cpu(), image.erode5(m))


def test_image_based_render_card_matches_cpu(cuda, tmp_path):
    """The blend of one eval view at 64x96 (tests/test_ibr.py's scene)
    on the card against the CPU: the geometric check's kernel (with its
    x/y) and the torch ops: float blends within 1e-5, three kernel
    launches."""
    from s_volsdf_tpu_torch.engine import ibr
    _, scan_folder, out_folder = chip_smoke.write_ibr_scene(str(tmp_path),
                                                            (64, 96))
    blends = []
    blend = ibr.laplacian_blending

    def recording(*args, **kwargs):
        out = blend(*args, **kwargs)
        blends.append(out.cpu())
        return out
    eval_ids = ibr.get_eval_ids
    try:
        ibr.laplacian_blending = recording
        ibr.get_eval_ids = lambda *a, **k: [eval_ids("DTU", 106)[0]]
        before = geo_consistency.geo_consistency.launches
        ibr.image_based_render(scan_folder, out_folder, "DTU", 3, device=cuda)
        assert geo_consistency.geo_consistency.launches == before + 3
        ibr.image_based_render(scan_folder, out_folder, "DTU", 3,
                               device="cpu")
    finally:
        ibr.laplacian_blending, ibr.get_eval_ids = blend, eval_ids
    assert (blends[0] - blends[1]).abs().max().item() <= 1e-5


def _stacked_sdf(cuda, S, cfg):
    params = [init_volsdf_params(torch.Generator().manual_seed(s), cfg.model,
                                 cuda) for s in range(S)]
    return params, stack_params(params)


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,n", [(1, 65536), (3, 65536), (4, 700),
                                 (2, 65537)])
def test_fused_sdf_scene_axis_equals_single_launches(cuda, mode, S, n):
    """One launch of S scenes (blockIdx.y the scene) against S single
    launches of the same weights and points: bit for bit, in both modes,
    with a ragged last block (700, 65,537 points) and at S = 1. Counted
    as one launch of S scenes."""
    cfg = tconfig.dtu_config()
    mcfg = cfg.model if mode == "float32" else dataclasses.replace(
        cfg.model, compute_dtype="bfloat16", activation_dtype="bfloat16")
    params, stacked = _stacked_sdf(cuda, S, cfg)
    pts = torch.tensor(np.random.default_rng(2).normal(size=(S, n, 3)),
                       dtype=torch.float32, device=cuda)
    fused_sdf.reset_launches()
    got = fused_sdf.fused_sdf_values(stacked.sdf, mcfg, pts, 3.0)
    torch.cuda.synchronize()
    assert fused_sdf.fused_sdf_values.launches == 1
    assert fused_sdf.fused_sdf_values.scene_launches == {S: 1}
    for s, p in enumerate(params):
        one = fused_sdf.fused_sdf_values(p.sdf, mcfg, pts[s].contiguous(), 3.0)
        assert torch.equal(got[s], one), s


def test_fused_sdf_scene_axis_refusals(cuda):
    """A pack of another mode or of another number of scenes, and points
    without the scene axis, raise before any launch."""
    cfg = tconfig.dtu_config()
    params, stacked = _stacked_sdf(cuda, 2, cfg)
    pts = torch.zeros(2, 128, 3, device=cuda)
    bf16 = dataclasses.replace(cfg.model, compute_dtype="bfloat16")
    fused_sdf.reset_launches()
    with pytest.raises(ValueError, match="pack"):
        fused_sdf.fused_sdf_values(stacked.sdf, cfg.model, pts, 3.0,
                                   pack=fused_sdf.pack_sdf_scenes(stacked.sdf,
                                                                  bf16))
    with pytest.raises(ValueError, match="scenes"):
        fused_sdf.fused_sdf_values(stacked.sdf, cfg.model, pts, 3.0,
                                   pack=fused_sdf.pack_sdf(params[0].sdf,
                                                           cfg.model))
    with pytest.raises(ValueError, match="S, N, 3"):
        fused_sdf.fused_sdf_values(stacked.sdf, cfg.model, pts[0], 3.0)
    assert fused_sdf.fused_sdf_values.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 3])
def test_cost_mapping_scene_axis_equals_single_launches(cuda, dtype, S):
    """One launch of S scenes' volumes (bench.py's shapes, a sphere of
    another radius a scene) against S single launches: pj, pi and valid
    bit for bit, counted as one launch of S scenes."""
    scenes = chip_smoke.ms_scenes(cuda, S)
    vols = [dataclasses.replace(m, prob=m.prob.to(dtype)) for _, m in scenes]
    stacked = cost_mapping.check_volumes_scenes(vols)
    xyz = torch.stack([chip_smoke.cost_mapping_samples(sc, s % 3, cuda)
                       for s, (sc, _) in enumerate(scenes)])
    onehot = torch.eye(3, device=cuda)[[(s + 1) % 3 for s in range(S)]]
    cost_mapping.reset_launches()
    got = cost_mapping.cost_mapping(None, xyz, onehot, stacked)
    torch.cuda.synchronize()
    assert cost_mapping.cost_mapping.scene_launches == {S: 1}
    for s, m in enumerate(vols):
        one = cost_mapping.cost_mapping(None, xyz[s], onehot[s],
                                        cost_mapping.check_volumes(m))
        for a, b in zip(got, one):
            assert torch.equal(a[s], b), s
        assert 0 < int(one[2].sum()) < one[2].numel()


def test_cost_mapping_scene_axis_refusals(cuda):
    """Volumes of other shapes, dtypes or settings do not stack; samples
    or one-hots without the scene axis, and volumes replaced after the
    copy, raise before any launch."""
    scene = make_sphere_scene(3, (48, 64))
    a = chip_smoke.make_volumes(scene, (16, 12, 16), cuda)
    for other in (chip_smoke.make_volumes(scene, (8, 12, 16), cuda),
                  dataclasses.replace(a, prob=a.prob.to(torch.bfloat16)),
                  dataclasses.replace(a, inverse_depth=True)):
        with pytest.raises(ValueError, match="one lockstep launch"):
            cost_mapping.check_volumes_scenes([a, other])
    stacked = cost_mapping.check_volumes_scenes([a, a])
    xyz = torch.zeros(2, 4, 5, 3, device=cuda)
    onehot = torch.eye(3, device=cuda)[:2]
    cost_mapping.reset_launches()
    with pytest.raises(ValueError, match="xyz"):
        cost_mapping.cost_mapping(None, xyz[0], onehot, stacked)
    with pytest.raises(ValueError, match="view_onehot"):
        cost_mapping.cost_mapping(None, xyz, onehot[0], stacked)
    with pytest.raises(ValueError, match="check_volumes"):
        cost_mapping.cost_mapping(None, xyz, onehot, dataclasses.replace(
            stacked, scenes=(a, dataclasses.replace(a, prob=a.prob * 1))))
    assert cost_mapping.cost_mapping.launches == 0


def test_lockstep_tracks_serial_on_card(cuda):
    """Two scenes in lockstep at float32 (a small model on 96x128 scenes)
    against two serial trainers: every step's loss within 1e-4 relative
    over 5 steps (cuBLAS's batched and single products may sum in other
    orders) and one launch of each kernel for the two scenes a step."""
    cfg = chip_smoke.float32_dtu_config()
    cfg.model.implicit.dims = (64,) * 4
    cfg.model.implicit.skip_in = (2,)
    cfg.train.num_pixels = 128
    scenes = [(sc, chip_smoke.make_volumes(sc, (32, 24, 32), cuda))
              for sc in (make_sphere_scene(3, (96, 128), sphere_radius=r)
                         for r in (0.8, 0.6))]
    serial = chip_smoke.ms_trainers(cfg, scenes, cuda)
    for t in serial:
        t.run(5)
    joint = chip_smoke.ms_trainers(cfg, scenes, cuda)
    fused_sdf.reset_launches()
    cost_mapping.reset_launches()
    chip_smoke.run_joint(joint, 5)
    assert fused_sdf.fused_sdf_values.scene_launches == {2: 5}
    assert cost_mapping.cost_mapping.scene_launches == {2: 5}
    for a, b in zip(serial, joint):
        np.testing.assert_allclose([lo.loss for lo in b.losses],
                                   [lo.loss for lo in a.losses], rtol=1e-4)


def _small_sharded_setup(device):
    """A float32 trainer of a small model on a 96x128 sphere scene with
    informative volumes, their kernel copy, and a drawn batch of 128
    rays: (config, trainer, volumes, batch)."""
    from s_volsdf_tpu_torch.engine.train_step import (draw_step_inputs,
                                                      pack_for_chunk)
    cfg = chip_smoke.float32_dtu_config()
    cfg.model.implicit.dims = (64,) * 4
    cfg.model.implicit.skip_in = (2,)
    cfg.train.num_pixels = 128
    t = chip_smoke.make_trainer(cfg, (96, 128), (32, 24, 32), device)
    mvs = pack_for_chunk(cfg, t.mvs)
    batch = draw_step_inputs(t.scene_tensors(),
                             torch.Generator(device=device).manual_seed(5),
                             cfg=cfg, n_views=3, img_res=(96, 128),
                             n_rays=cfg.train.num_pixels)
    return cfg, t, mvs, batch


def test_one_nccl_rank_step_equals_train_step(cuda, tmp_path):
    """With one NCCL rank every collective is the identity: the sharded
    step equals train_step to the bit."""
    from s_volsdf_tpu_torch.engine.train_step import shard_batch, train_step
    from s_volsdf_tpu_torch.parallel import mesh as pmesh
    from s_volsdf_tpu_torch.parallel.train_parallel import (
        make_sharded_train_step)
    pmesh.init_process_group(
        "cuda", init_method="file://" + str(tmp_path / "store"),
        env={"WORLD_SIZE": "1", "RANK": "0"})
    try:
        group = pmesh.node_group()
        cfg, a, mvs, batch = _small_sharded_setup(cuda)
        _, b, _, _ = _small_sharded_setup(cuda)
        _, la = train_step(a.state, batch, None, mvs, cfg=cfg, tx=a.tx,
                           use_mvs=True)
        step = make_sharded_train_step(cfg, b.tx, group, use_mvs=True)
        _, lb = step(b.state, shard_batch(batch, group), None, mvs)
        assert float(la.loss) == float(lb.loss)
        for p, q in zip(a.state.params.parameters(),
                        b.state.params.parameters()):
            assert torch.equal(p, q)
    finally:
        pmesh.shutdown()


def _gloo_pair_step():
    """Each of two gloo ranks on one card: the sharded step's averaged
    gradients and, on the first rank, the one-process step's."""
    from s_volsdf_tpu_torch.engine.train_step import (loss_and_grads,
                                                      mean_over_group,
                                                      shard_batch)
    from s_volsdf_tpu_torch.parallel import mesh as pmesh
    group = pmesh.node_group()
    cfg, t, mvs, batch = _small_sharded_setup(pmesh.rank_device())
    grads, lo = mean_over_group(group, *loss_and_grads(
        t.state.params, cfg, shard_batch(batch, group), None, mvs, 0))
    want, wlo = loss_and_grads(t.state.params, cfg, batch, None, mvs, 0)
    return {"loss": float(lo.loss), "want_loss": float(wlo.loss.detach()),
            "grads": [g.cpu().numpy() for g in grads],
            "want": [w.cpu().numpy() for w in want]}


def test_two_gloo_ranks_on_card_match_one_process(cuda):
    """Two gloo ranks sharing the card: the sharded step's gradients and
    loss against the one-process step within the one-step bars of
    tests/test_torch_train_step.py; equal on both ranks."""
    from s_volsdf_tpu_torch.parallel import mesh as pmesh
    r0, r1 = pmesh.run_local_ranks(_gloo_pair_step, 2, device="cuda:0",
                                   backend="gloo", timeout=300)
    np.testing.assert_allclose(r0["loss"], r0["want_loss"], rtol=1e-4)
    for g0, g1, w in zip(r0["grads"], r1["grads"], r0["want"]):
        np.testing.assert_array_equal(g0, g1)
        np.testing.assert_allclose(g0, w, rtol=1e-3, atol=1e-5)
