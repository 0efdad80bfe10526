"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit: it carries the
``cuda`` marker and skips (inside the fixture, never at import) where
``torch.cuda.is_available()`` is false.  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not use.)

The comparison is bitwise: each kernel repeats its plain version's
arithmetic in the same order, built without fast-math or FMA contraction.
"""

import warnings

import numpy as np
import pytest
import torch

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.models.astaroth import AstarothSim
from stencil_tpu_torch.models.jacobi import COLD_TEMP, HOT_TEMP, Jacobi3D
from stencil_tpu_torch.ops import halo_blend as hb
from stencil_tpu_torch.ops import jacobi_kernels as jk
from stencil_tpu_torch.ops import pack as pk
from stencil_tpu_torch.ops import stream as st

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rand(shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).random(shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("shape,k", [((66, 70, 130), k) for k in (1, 2, 3, 4, 5, 6, 7, 8, 12)]
                         + [((16, 5, 7), 4), ((24, 9, 11), 12), ((9, 2, 1), 4), ((2, 3, 3), 1)])
def test_wrap_kernel_equals_plain(dev, shape, k):
    """Ragged shapes that both spheres cross, and axes shorter than a
    march's apron (every index wraps more than once)."""
    block = _rand(shape, 1, dev)
    keep = block.clone()
    before = jk.jacobi_wrap_step.launches
    got = jk.jacobi_wrap_step(block, k)
    torch.cuda.synchronize()
    assert jk.jacobi_wrap_step.launches == before + 1  # one a call, whatever its marches
    assert torch.equal(block, keep)
    assert torch.equal(got, jk.jacobi_wrap_step_plain(block, k))


@pytest.mark.parametrize("k", [1, 8])
def test_wrap_kernel_equals_plain_at_the_main_path_shape(dev, k):
    block = _rand((512, 512, 512), 2, dev)
    got = jk.jacobi_wrap_step(block, k)
    torch.cuda.synchronize()
    assert torch.equal(got, jk.jacobi_wrap_step_plain(block, k))
    plan = jk.jacobi_wrap_launch((512, 512, 512), k)
    assert plan["depths"] == jk.wrap_march_depths(k) and plan["launches"] == len(plan["depths"])
    assert plan["blocks_per_sm"] >= 1 and plan["smem_bytes"] <= jk.SMEM_PER_BLOCK


def _crossing_origins(n, ext, gs, dev):
    """Block b's global start: x such that its ``ext`` planes hold the hot
    sphere's centre (b even) or the cold one's (b odd), y and z near 0, so
    that the spheres (centred at gy/2, gz/2) cross the blocks."""
    hot_x, cold_x, _ = jk.sphere_params(gs[0])
    return torch.tensor([[((hot_x, cold_x)[b % 2] - ext // 2) % gs[0], b % gs[1], (3 * b) % gs[2]]
                         for b in range(n)], dtype=torch.int32, device=dev)


#: (n, X, Y, Z) of the plane form's cases: the ragged (2, 66, 70, 130);
#: axes shorter than one 32 x 64 tile; partial tiles in y and z; the
#: 32 x 64 tile exactly; n = 1 and n = 8
PLANE_CASES = [(2, 66, 70, 130), (1, 3, 3, 3), (1, 5, 4, 7), (8, 12, 35, 67), (8, 20, 32, 64), (1, 9, 61, 125)]


@pytest.mark.parametrize("n,X,Y,Z", PLANE_CASES)
def test_plane_kernel_equals_plain(dev, n, X, Y, Z):
    """Both spheres cross the blocks (n >= 2, wide enough); the whole block
    is compared, the shell copied through."""
    gs = (60, Y - 2 + 1, Z - 2 + 2)
    blocks = _rand((n, X, Y, Z), 2, dev)
    origins = _crossing_origins(n, X - 2, gs, dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (Y - 2, Z - 2), gs, dev) for o in origins])
    before = jk.jacobi_plane_step.launches
    got = jk.jacobi_plane_step(blocks, origins, d2, gs)
    torch.cuda.synchronize()
    assert jk.jacobi_plane_step.launches == before + 1  # all blocks in one launch
    want = jk.jacobi_plane_step_plain(blocks, origins, d2, gs)
    if n >= 2 and min(X, Y, Z) >= 12:
        assert (want == jk.HOT_TEMP).any() and (want == jk.COLD_TEMP).any()
    assert torch.equal(got, want)
    # out= is written whole: no cell left from what it held
    out = torch.full_like(blocks, float("nan"))
    jk.jacobi_plane_step(blocks, origins, d2, gs, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("size", [512, 511])
def test_plane_kernel_equals_plain_at_the_main_path_shape(dev, size):
    """The shell route's blocks on 2x2x2, (8, 258^3): 512^3, and 511^3
    whose last shard a side is padded (255 valid planes, the rest
    compared all the same)."""
    half, gs = 256, (size,) * 3
    blocks = _rand((8, half + 2, half + 2, half + 2), 3, dev)
    org = torch.tensor([[x, y, z] for x in (0, half) for y in (0, half) for z in (0, half)],
                       dtype=torch.int32, device=dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (half, half), gs, dev) for o in org])
    got = jk.jacobi_plane_step(blocks, org, d2, gs)
    torch.cuda.synchronize()
    assert torch.equal(got, jk.jacobi_plane_step_plain(blocks, org, d2, gs))
    plan = jk.jacobi_plane_launch(tuple(blocks.shape))
    assert plan["blocks_per_sm"] >= 1 and plan["sms"] >= 1 and plan["smem_bytes"] <= jk.SMEM_PER_BLOCK
    assert plan["blocks"] == plan["tiles_z"] * plan["tiles_y"] * 8 * plan["nchunks"]
    assert plan["xchunk"] * plan["nchunks"] >= half > plan["xchunk"] * (plan["nchunks"] - 1)
    assert plan["waves"] >= 4  # the x chunking's least where the extent allows it


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_blend_kernel_equals_plain(dev, axis, dtype):
    blocks = (_rand((3, 17, 19, 23), 3, dev) * 100).to(dtype)
    for r, pos in ((1, 0), (2, 5), (3, blocks.shape[1 + axis] - 3)):
        shape = list(blocks.shape)
        shape[1 + axis] = r
        slab = (_rand(shape, 4 + r, dev) * 100).to(dtype)
        want = hb.blend_slab_plain(blocks.clone(), slab, axis, pos)
        got = hb.blend_slab(blocks.clone(), slab, axis, pos)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _wavefront_case(dev, m, s_off, ring, slabs, z_valid=None):
    """Kernel and plain version of one wavefront call over 2 ragged blocks;
    returns both results and the valid-region slices."""
    Xr, Yr, Z = 22, 26, 128 if ring else 30
    gs = (2 * (Xr - 2 * s_off) + 3, 2 * (Yr - 2 * s_off), 2 * Z)
    raw = _rand((2, Xr, Yr, Z), 7, dev)
    org = torch.tensor([[5, 0, 7], [gs[0] - 3, Yr - 2 * s_off, 0]], dtype=torch.int32, device=dev)
    zs = _rand((2, Xr, 2 * s_off, Yr), 8, dev) if slabs else None
    if ring:
        d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - s_off, int(o[2]), s_off, Yr, Z, gs, dev)
                          for o in org])
        args = (raw, m, org, d2, gs, zs)
        kw = dict(interior_offset=s_off)
        fn, plain, zsl = jk.jacobi_zring_wavefront_step, jk.jacobi_zring_wavefront_step_plain, slice(None)
    else:
        d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - s_off, int(o[2]) - s_off, (Yr, Z), gs, dev)
                          for o in org])
        args = (raw, m, org, d2, gs)
        kw = dict(interior_offset=s_off, z_slabs=zs, z_valid=z_valid)
        fn, plain = jk.jacobi_shell_wavefront_step, jk.jacobi_shell_wavefront_step_plain
        zsl = slice(s_off, (z_valid or Z) - s_off)
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1  # m levels in one launch
    want = plain(*args, **kw)
    if not slabs:
        got, want = (got, None), (want, None)
    return got, want, slice(s_off, -s_off), zsl


@pytest.mark.parametrize("m,s_off", [(1, 1), (2, 2), (2, 3), (3, 4)])
@pytest.mark.parametrize("slabs", [False, True])
def test_shell_wavefront_kernel_equals_plain(dev, m, s_off, slabs):
    got, want, S, zsl = _wavefront_case(dev, m, s_off, False, slabs, z_valid=27)
    assert torch.equal(got[0][:, S, S, zsl], want[0][:, S, S, zsl])
    if slabs:
        assert torch.equal(got[1][:, S, :, S], want[1][:, S, :, S])


@pytest.mark.parametrize("m,s_off", [(1, 1), (2, 2), (2, 3), (3, 4)])
def test_zring_wavefront_kernel_equals_plain(dev, m, s_off):
    got, want, S, zsl = _wavefront_case(dev, m, s_off, True, True)
    assert torch.equal(got[0][:, S, S], want[0][:, S, S])
    assert torch.equal(got[1][:, S, :, S], want[1][:, S, :, S])


def _deep_args(dev, n, m, s_off, form):
    """Seeded arguments of one deep wavefront call (``form``: "ring",
    "slabs" or "shell") over n ragged blocks: partial tiles in y and z, an
    interior x extent of 41 planes (prime: chunks of more than one plane
    leave a short last one), and gx so small that both spheres cross every
    block; n = 1 gives single blocks (3-D tensors)."""
    Xr, Yr = 2 * s_off + 41, 2 * s_off + 29
    Z = 70 if form == "ring" else 75
    zv = None if form == "ring" else Z - 3
    gs = (2 * s_off + 5, Yr - 2 * s_off, Z if form == "ring" else zv - 2 * s_off)
    lead = () if n == 1 else (n,)
    raw = _rand(lead + (Xr, Yr, Z), 60 + m, dev)
    org = torch.tensor([[(3 * b) % gs[0], b, 2 * b] for b in range(n)], dtype=torch.int32, device=dev)
    if form == "ring":
        d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - s_off, int(o[2]), s_off, Yr, Z, gs, dev) for o in org])
    else:
        d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - s_off, int(o[2]) - s_off, (Yr, Z), gs, dev) for o in org])
    zs = _rand(lead + (Xr, 2 * s_off, Yr), 61 + m, dev) if form != "shell" else None
    if n == 1:
        org, d2 = org[0], d2[0]
    return raw, org, d2, zs, gs, zv


@pytest.mark.parametrize("m,s_off", [(4, 4), (4, 5), (6, 6), (6, 8), (8, 8), (8, 9)])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("form", ["ring", "slabs", "shell"])
def test_deep_wavefront_kernel_equals_plain(dev, form, n, m, s_off):
    """The depths the main path runs (m = 8 at 512^3 on 2x2x2), one march
    (m = 4) and two (m = 6, 8), bitwise on the valid region, the clamp of
    both spheres included."""
    raw, org, d2, zs, gs, zv = _deep_args(dev, n, m, s_off, form)
    S = slice(s_off, -s_off)
    if form == "ring":
        fn, plain, zsl = jk.jacobi_zring_wavefront_step, jk.jacobi_zring_wavefront_step_plain, slice(None)
        args, kw = (raw, m, org, d2, gs, zs), dict(interior_offset=s_off)
    else:
        fn, plain, zsl = jk.jacobi_shell_wavefront_step, jk.jacobi_shell_wavefront_step_plain, slice(s_off, zv - s_off)
        args, kw = (raw, m, org, d2, gs), dict(interior_offset=s_off, z_slabs=zs, z_valid=zv)
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args, **kw)
    if zs is None:
        got, want = (got,), (want,)
    valid = want[0][..., S, S, zsl]
    assert (valid == jk.HOT_TEMP).any() and (valid == jk.COLD_TEMP).any()
    assert torch.equal(got[0][..., S, S, zsl], valid)
    if zs is not None:
        assert torch.equal(got[1][..., S, :, S], want[1][..., S, :, S])


@pytest.mark.parametrize("m", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("form", ["z-ring", "shell z-slab", "shell"])
def test_wavefront_plan_report(dev, form, m):
    """The plan entry at the main path's shapes: the form asked for, one or
    two marches, a block's shared memory within the depth plan's model, and
    a grid of whole blocks an SM."""
    ring, slabs = form == "z-ring", form != "shell"
    shape = (8, 256 + 2 * m, 256 + 2 * m, 256 if ring else 256 + 2 * m)
    plan = jk.jacobi_wavefront_launch(shape, m, ring=ring, slabs=slabs)
    assert plan["form"] == form
    assert plan["launches"] == jk.wavefront_marches(m)
    assert plan["depth"] == (m if plan["launches"] == 1 else (m + 1) // 2)
    assert 0 < plan["smem_bytes"] <= jk.wavefront_smem_bytes(m)
    assert plan["blocks_per_sm"] >= 1 and plan["sms"] >= 1 and plan["threads"] % 32 == 0
    assert plan["blocks"] == plan["tiles_z"] * plan["tiles_y"] * 8 * plan["nchunks"]
    ix = 256 + 2 * (m - plan["depth"])  # the first march's output planes: [s - (m - depth), ...)
    assert plan["xchunk"] * plan["nchunks"] >= ix > plan["xchunk"] * (plan["nchunks"] - 1)


def test_wavefront_plan_of_the_deep_cases_leaves_a_short_chunk(dev):
    """``_deep_args``' x extent leaves a short last chunk on some launch."""
    shorts = []
    for m, s_off in ((4, 5), (8, 9)):
        raw = _deep_args(dev, 3, m, s_off, "ring")[0]
        plan = jk.jacobi_wavefront_launch(tuple(raw.shape), m, s_off, ring=True, slabs=True)
        ix = raw.shape[1] - 2 * (s_off - (m - plan["depth"]))
        shorts.append(ix % plan["xchunk"] != 0)
    assert any(shorts)


#: (n, X, Y, Z) of the slab form's cases: X = 2 (the contract's least) with
#: axes shorter than a tile and with partial tiles; partial tiles in y and
#: z; the 30 x 62 outputs of a tile exactly; n = 1, 3 and 8
SLAB_CASES = [(1, 2, 3, 5), (1, 2, 1, 1), (8, 2, 31, 63), (3, 7, 33, 70), (8, 16, 40, 129), (8, 5, 30, 62),
              (1, 9, 61, 125)]


@pytest.mark.parametrize("n,X,Y,Z", SLAB_CASES)
@pytest.mark.parametrize("faces", ["random", "self"])
def test_slab_kernel_equals_plain(dev, n, X, Y, Z, faces):
    """Ragged blocks (partial tiles in y and z, short axes), random face
    slabs or each block's own faces; both spheres cross the blocks (n >= 2,
    wide enough)."""
    gs = (60, Y + 1, Z + 2)
    block = _rand((n, X, Y, Z), 50, dev)
    if faces == "self":
        slabs = [t.contiguous() for t in (block[:, -1], block[:, 0], block[:, :, -1], block[:, :, 0],
                                          block[..., -1], block[..., 0])]
    else:
        slabs = [_rand((n,) + s, 51 + i, dev)
                 for i, s in enumerate(((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y)))]
    org = _crossing_origins(n, X, gs, dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (Y, Z), gs, dev) for o in org])
    before = jk.jacobi_slab_step.launches
    got = jk.jacobi_slab_step(block, *slabs, org, d2, gs)
    torch.cuda.synchronize()
    assert jk.jacobi_slab_step.launches == before + 1  # all blocks in one launch
    want = jk.jacobi_slab_step_plain(block, *slabs, org, d2, gs)
    if n >= 2 and min(X, Y, Z) >= 5:
        assert (want == jk.HOT_TEMP).any() and (want == jk.COLD_TEMP).any()
    assert torch.equal(got, want)


def test_slab_kernel_equals_plain_at_the_main_path_shape(dev):
    """The slab route's call on 2x2x2 at 512^3: (8, 256^3), six random
    slabs; and its plan."""
    half, gs = 256, (512,) * 3
    block = _rand((8, half, half, half), 4, dev)
    slabs = [_rand((8, half, half), 5 + i, dev) for i in range(6)]
    org = torch.tensor([[x, y, z] for x in (0, half) for y in (0, half) for z in (0, half)],
                       dtype=torch.int32, device=dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (half, half), gs, dev) for o in org])
    got = jk.jacobi_slab_step(block, *slabs, org, d2, gs)
    torch.cuda.synchronize()
    assert torch.equal(got, jk.jacobi_slab_step_plain(block, *slabs, org, d2, gs))
    plan = jk.jacobi_slab_launch(tuple(block.shape))
    assert plan["blocks_per_sm"] >= 1 and plan["smem_bytes"] <= jk.SMEM_PER_BLOCK
    assert plan["blocks"] == plan["tiles_z"] * plan["tiles_y"] * 8 * plan["nchunks"]
    assert (plan["tiles_y"], plan["tiles_z"]) == (9, 5)  # 30 x 62 outputs a tile over 256^2
    assert plan["waves"] >= 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("shape", [(4, 17, 19, 23), (17, 19, 23), (3, 11, 9, 520), (2, 40, 41, 23)])
def test_blend_dynamic_kernel_equals_plain(dev, axis, dtype, shape):
    """Every element width (1, 2, 4, 8 bytes); 4-D blocks and a 3-D one (n =
    1, one offset); rows of 23 cells (the cell kernel, whose stages of cells
    span several blocks, or at (2, 40, 41, 23) lie inside one) and of 520
    (the row kernel on x and y, every alignment a block row can have);
    per-block offsets as the uneven exchange makes them (the last block
    differs), distinct ones, and offsets below 0 and past ext - r
    (clamped)."""
    blocks = (_rand(shape, 60, dev) * 100).to(dtype)
    n, lead = (shape[0], 1) if len(shape) == 4 else (1, 0)
    ext = blocks.shape[lead + axis]
    for r in (1, 2, 3):
        slab_shape = list(blocks.shape)
        slab_shape[lead + axis] = r
        slab = (_rand(slab_shape, 61 + r, dev) * 100 + 1).to(dtype)
        for pos in ([ext - r] * (n - 1) + [ext - r - 4], [0, 5, ext - r, ext + 9], [n - 1 - b for b in range(n)],
                    [-2, ext, -7, 1], [ext - r + 1] * n):
            p = torch.tensor(pos[:n], dtype=torch.int32, device=dev)
            before = hb.blend_slab_dynamic.launches
            got = hb.blend_slab_dynamic(blocks.clone(), slab, axis, p)
            torch.cuda.synchronize()
            assert hb.blend_slab_dynamic.launches == before + 1
            assert torch.equal(got, hb.blend_slab_dynamic_plain(blocks.clone(), slab, axis, p)), (r, pos[:n])


def test_model_routes_agree_on_card(dev):
    wrap = Jacobi3D(32, 32, 32, kernel_impl="cuda")
    shell = Jacobi3D(32, 32, 32, kernel_impl="cuda", pallas_path="shell")
    shell.dd.set_partition(2, 2, 2)
    wavefront = Jacobi3D(32, 32, 32, kernel_impl="cuda")
    wavefront.dd.set_partition(2, 2, 2)
    slab = Jacobi3D(32, 32, 32, kernel_impl="cuda", pallas_path="slab")
    slab.dd.set_partition(2, 2, 2)
    ref = Jacobi3D(32, 32, 32)
    for m in (wrap, shell, wavefront, slab, ref):
        m.realize()
        m.step(6)
    assert wavefront._pallas_path == "wavefront" and slab._pallas_path == "slab"
    assert np.array_equal(wrap.temperature(), shell.temperature())
    assert np.array_equal(wrap.temperature(), wavefront.temperature())
    assert np.array_equal(wrap.temperature(), slab.temperature())
    np.testing.assert_allclose(wrap.temperature(), ref.temperature(), rtol=1e-6)


def test_uneven_routes_agree_on_card(dev):
    """33^3 over 2x2x2 (17 + 16 cells a side): auto (the plain wavefront),
    shell and the torch engine against one unpadded subdomain."""
    wrap = Jacobi3D(33, 33, 33, kernel_impl="cuda")
    runs = [Jacobi3D(33, 33, 33, kernel_impl="cuda", **kw) for kw in ({}, {"pallas_path": "shell"})]
    ref = Jacobi3D(33, 33, 33)
    for m in runs + [ref]:
        m.dd.set_partition(2, 2, 2)
    for m in [wrap] + runs + [ref]:
        m.realize()
        m.step(7)
    assert runs[0]._pallas_path == "wavefront" and not runs[0]._wavefront_z_slabs
    assert runs[0].dd.padded()
    for m in runs:
        assert np.array_equal(m.temperature(), wrap.temperature())
    np.testing.assert_allclose(ref.temperature(), wrap.temperature(), rtol=1e-6)


# --- the shell packs of the packed exchange routes (csrc/pack.cu) ------------------------

PACKS = {"z": (2, pk.pack_zshell_pallas, pk.pack_zshell_pallas_plain, pk.unpack_zshell_pallas,
               pk.unpack_zshell_pallas_plain),
         "y": (1, pk.pack_yshell_pallas, pk.pack_yshell_pallas_plain, pk.unpack_yshell_pallas,
               pk.unpack_yshell_pallas_plain)}


def _hold_packs(axis, blocks, windows, seed):
    """Each pack and unpack kernel against its plain version at each
    ``(start, depth)`` window: bitwise, one launch a call."""
    _, pack, pack_plain, unpack, unpack_plain = PACKS[axis]
    for start, depth in windows:
        before = (pack.launches, unpack.launches)
        buf = pack(blocks, start, depth)
        torch.cuda.synchronize()
        assert torch.equal(buf, pack_plain(blocks, start, depth))
        new = (_rand(tuple(buf.shape), seed + start, blocks.device) * 100).to(blocks.dtype)
        got = unpack(blocks.clone(), new, start, depth)
        torch.cuda.synchronize()
        assert torch.equal(got, unpack_plain(blocks.clone(), new, start, depth))
        assert (pack.launches, unpack.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("axis", ["z", "y"])
def test_shell_pack_kernels_equal_plain(dev, axis, dtype):
    """Ragged blocks, one and three at once, windows at both ends and inside."""
    blocks = (_rand((3, 17, 19, 23), 70, dev) * 100).to(dtype)
    ext = blocks.shape[1 + PACKS[axis][0]]
    windows = ((0, 1), (5, 3), (ext - 3, 3), (0, ext))
    _hold_packs(axis, blocks, windows, 71)
    _hold_packs(axis, blocks[1].contiguous(), windows, 72)


@pytest.mark.parametrize("axis", ["z", "y"])
def test_shell_pack_kernels_at_main_path_shapes(dev, axis):
    """Astaroth's plane route at 512^3 on 2x2x2: 8 blocks of 262^3, the
    radius-3 shell's four windows."""
    blocks = _rand((8, 262, 262, 262), 73, dev)
    _hold_packs(axis, blocks, ((256, 3), (3, 3), (0, 3), (259, 3)), 74)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.uint8])
def test_slab_pack_kernels_equal_plain(dev, dtype):
    """A ragged block; boxes on faces, an edge, a corner and the whole block."""
    block = (_rand((17, 19, 23), 80, dev) * 100).to(dtype)
    boxes = ((Dim3(0, 0, 0), Dim3(3, 19, 23)), (Dim3(2, 16, 0), Dim3(13, 3, 23)), (Dim3(1, 2, 20), Dim3(15, 17, 3)),
             (Dim3(14, 0, 5), Dim3(3, 3, 11)), (Dim3(14, 16, 20), Dim3(3, 3, 3)), (Dim3(0, 0, 0), Dim3(17, 19, 23)))
    for i, (pos, ext) in enumerate(boxes):
        before = (pk.pallas_pack_slab.launches, pk.pallas_unpack_slab.launches)
        slab = pk.pallas_pack_slab(block, pos, ext)
        torch.cuda.synchronize()
        assert torch.equal(slab, pk.pallas_pack_slab_plain(block, pos, ext))
        new = (_rand(tuple(ext), 81 + i, dev) * 100).to(dtype)
        got = pk.pallas_unpack_slab(block.clone(), new, pos, ext)
        torch.cuda.synchronize()
        assert torch.equal(got, pk.pallas_unpack_slab_plain(block.clone(), new, pos, ext))
        assert (pk.pallas_pack_slab.launches, pk.pallas_unpack_slab.launches) == (before[0] + 1, before[1] + 1)


# --- the descriptor launch path: the slab packs and the y-shell pair ------------------

SWEEP_DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.uint8]


def _at_offset(shape, dtype, off, seed, dev):
    """A C-contiguous tensor of ``shape`` whose data starts ``off`` elements
    past an aligned allocation, filled from ``seed``."""
    n = int(np.prod(shape))
    return (_rand((n + off,), seed, dev) * 100).to(dtype)[off:].view(shape)


@pytest.mark.parametrize("dtype", SWEEP_DTYPES)
def test_unpack_slab_kernel_alignment_sweep(dev, dtype):
    """Block rows that start at every offset mod 16 (an odd Z, every pz < 16,
    shifted block pointers), ez of 1, 3, 4, 5, 300 and the rest of the row
    (both sides of the row kernel's 512-byte threshold for every width), the
    slab's pointer 16-byte aligned and not; then boxes of several staged
    chunks with a ragged last one."""
    X, Y, Z = 4, 5, 521
    cases = [((X, Y, Z), (px, py, pz), (ex, ey, ez), boff, soff)
             for pz in range(16) for ez in (1, 3, 4, 5, 300, Z - pz)
             for px, py, ex, ey in ((1, 2, 2, 3), (0, 0, X, Y))
             for boff, soff in ((0, 0), (1, 1), (3, 0), (0, 1))]
    cases += [((40, 41, 9), (2, 1, pz), (37, 39, ez), 0, soff) for pz, ez in ((5, 3), (2, 6), (0, 9))
              for soff in (0, 1)]
    before = pk.pallas_unpack_slab.launches
    for i, (shape, pos, ext, boff, soff) in enumerate(cases):
        block = _at_offset(shape, dtype, boff, i, dev)
        slab = _at_offset(ext, dtype, soff, 10_000 + i, dev)
        want = pk.pallas_unpack_slab_plain(block.clone(), slab, Dim3.of(pos), Dim3.of(ext))
        got = pk.pallas_unpack_slab(block, slab, pos, ext)
        torch.cuda.synchronize()
        assert got is block
        assert torch.equal(got, want), (shape, pos, ext, boff, soff)
    assert pk.pallas_unpack_slab.launches == before + len(cases)


@pytest.mark.parametrize("dtype", SWEEP_DTYPES)
def test_pack_yshell_kernel_alignment_sweep(dev, dtype):
    """One block and three, Z odd, 1 and a 1,048-byte f32 row (8 mod 16),
    depth 1, 3 and the full extent, block pointers shifted so that rows
    start at every offset mod 16."""
    cases = [(lead + (X, Y, Z), (y0, depth), boff)
             for lead, X, Y, Z in (((), 3, 6, 1), ((3,), 3, 6, 7), ((), 5, 7, 262), ((3,), 2, 4, 333),
                                   ((3,), 2, 5, 64), ((1,), 2, 4, 521))
             for y0, depth in ((0, 1), (1, 3), (Y - 3, 3), (0, Y))
             for boff in (0, 1, 3, 5)]
    before = pk.pack_yshell_pallas.launches
    for i, (shape, (y0, depth), boff) in enumerate(cases):
        block = _at_offset(shape, dtype, boff, 20_000 + i, dev)
        buf = pk.pack_yshell_pallas(block, y0, depth)
        torch.cuda.synchronize()
        assert torch.equal(buf, pk.pack_yshell_pallas_plain(block, y0, depth)), (shape, y0, depth, boff)
    assert pk.pack_yshell_pallas.launches == before + len(cases)


@pytest.mark.parametrize("dtype", SWEEP_DTYPES)
def test_pack_slab_kernel_alignment_sweep(dev, dtype):
    """Block rows that start at every offset mod 16 (an odd Z, every pz < 16,
    shifted block pointers), ez of 1, 3, 4, 5, 300 and the rest of the row
    (both sides of the row kernel's 512-byte threshold for every width);
    then boxes of several staged chunks with a ragged last one."""
    X, Y, Z = 4, 5, 521
    cases = [((X, Y, Z), (px, py, pz), (ex, ey, ez), boff)
             for pz in range(16) for ez in (1, 3, 4, 5, 300, Z - pz)
             for px, py, ex, ey in ((1, 2, 2, 3), (0, 0, X, Y))
             for boff in (0, 1, 3)]
    cases += [((40, 41, 9), (2, 1, pz), (37, 39, ez), boff) for pz, ez in ((5, 3), (2, 6), (0, 9))
              for boff in (0, 1)]
    before = pk.pallas_pack_slab.launches
    for i, (shape, pos, ext, boff) in enumerate(cases):
        block = _at_offset(shape, dtype, boff, 30_000 + i, dev)
        got = pk.pallas_pack_slab(block, pos, ext)
        torch.cuda.synchronize()
        assert torch.equal(got, pk.pallas_pack_slab_plain(block, Dim3.of(pos), Dim3.of(ext))), (shape, pos, ext, boff)
    assert pk.pallas_pack_slab.launches == before + len(cases)


@pytest.mark.parametrize("dtype", SWEEP_DTYPES)
def test_unpack_yshell_kernel_alignment_sweep(dev, dtype):
    """One block and three; Z of 1, 7, 262, 333 and 521; depth 1, 3 and the
    full extent; windows at both ends; block and buffer pointers shifted so
    that rows start at every offset mod 16 on both sides.  Every cell
    outside the window keeps its value."""
    cases = [(lead + (X, Y, Z), (y0, depth), boff, uoff)
             for lead, X, Y, Z in (((), 3, 6, 1), ((3,), 3, 6, 7), ((), 5, 7, 262), ((3,), 2, 4, 333),
                                   ((1,), 2, 4, 521))
             for y0, depth in ((0, 1), (1, 3), (Y - 3, 3), (Y - 1, 1), (0, Y))
             for boff, uoff in ((0, 0), (1, 1), (3, 0), (0, 5))]
    before = pk.unpack_yshell_pallas.launches
    for i, (shape, (y0, depth), boff, uoff) in enumerate(cases):
        block = _at_offset(shape, dtype, boff, 40_000 + i, dev)
        buf = _at_offset(pk.yshell_buffer_shape(shape, depth), dtype, uoff, 50_000 + i, dev)
        old = block.clone()
        want = pk.unpack_yshell_pallas_plain(block.clone(), buf, y0, depth)
        got = pk.unpack_yshell_pallas(block, buf, y0, depth)
        torch.cuda.synchronize()
        assert got is block
        assert torch.equal(got, want), (shape, y0, depth, boff, uoff)
        Y = shape[-2]
        assert torch.equal(got.narrow(-2, 0, y0), old.narrow(-2, 0, y0))
        assert torch.equal(got.narrow(-2, y0 + depth, Y - y0 - depth), old.narrow(-2, y0 + depth, Y - y0 - depth))
    assert pk.unpack_yshell_pallas.launches == before + len(cases)


#: (block shape, z windows) of the z-shell tile kernels' sweep: X and Y
#: ragged against the 32 x 32 tile, X or Y of 1, n = 1 and a bare block; every
#: z0 mod 8 at depth 1, 3 and 5 (runs that start at every offset of a sector
#: for every width), the last cell and depth = Z
ZSHELL_CASES = [(shape, sorted({(z0, d) for z0 in range(8) for d in (1, 3, 5)} | {(shape[-1] - 1, 1), (0, shape[-1])}))
                for shape in ((2, 33, 65, 13), (1, 70, 40, 16), (3, 1, 40, 13), (2, 40, 1, 14), (17, 19, 23),
                              (1, 64, 32, 21))]


@pytest.mark.parametrize("dtype", SWEEP_DTYPES)
def test_zshell_kernels_tile_and_window_sweep(dev, dtype):
    """The z-shell pack and unpack, bitwise against the plain versions, on
    the shapes and windows of ``ZSHELL_CASES``, with block and buffer
    pointers shifted off their allocation's alignment."""
    before = (pk.pack_zshell_pallas.launches, pk.unpack_zshell_pallas.launches)
    calls = 0
    for i, (shape, windows) in enumerate(ZSHELL_CASES):
        for j, (z0, depth) in enumerate(windows):
            boff, uoff = (0, 0) if j % 2 else (1, 3)
            block = _at_offset(shape, dtype, boff, 60_000 + 100 * i + j, dev)
            buf = pk.pack_zshell_pallas(block, z0, depth)
            torch.cuda.synchronize()
            assert torch.equal(buf, pk.pack_zshell_pallas_plain(block, z0, depth)), (shape, z0, depth, boff)
            new = _at_offset(tuple(buf.shape), dtype, uoff, 70_000 + 100 * i + j, dev)
            want = pk.unpack_zshell_pallas_plain(block.clone(), new, z0, depth)
            got = pk.unpack_zshell_pallas(block, new, z0, depth)
            torch.cuda.synchronize()
            assert got is block
            assert torch.equal(got, want), (shape, z0, depth, boff, uoff)
            calls += 1
    assert (pk.pack_zshell_pallas.launches, pk.unpack_zshell_pallas.launches) == (before[0] + calls,
                                                                                  before[1] + calls)


@pytest.mark.parametrize("shape", [(8, 262, 262, 262), (2, 33, 65, 13), (17, 19, 23)])
def test_zshell_unpack_writes_no_cell_outside_its_window(dev, shape):
    """A block of random values: after the unpack every cell outside the
    window holds its old bits and every cell inside the buffer's."""
    Z = shape[-1]
    for i, (z0, depth) in enumerate(((0, 3), (Z - 3, 3), (3, 3), (Z // 2, 1))):
        block = _rand(shape, 64 + i, dev) * 100
        old = block.clone()
        buf = _rand(pk.zshell_buffer_shape(shape, depth), 65 + i, dev) - 1  # no value of the block's range
        pk.unpack_zshell_pallas(block, buf, z0, depth)
        torch.cuda.synchronize()
        assert torch.equal(block.narrow(-1, 0, z0), old.narrow(-1, 0, z0))
        assert torch.equal(block.narrow(-1, z0 + depth, Z - z0 - depth), old.narrow(-1, z0 + depth, Z - z0 - depth))
        assert torch.equal(block.narrow(-1, z0, depth), buf.transpose(-3, -1))


def test_descriptor_launches_of_two_shapes_in_turn(dev):
    """Each shape keeps its own cached launch: blocks of two shapes, in turn."""
    blocks = [_rand((9, 10, 11), 90, dev), _rand((12, 10, 13), 91, dev)]
    pos, ext = Dim3(2, 1, 3), Dim3(4, 7, 5)
    for rep in range(2):
        for i, blk in enumerate(blocks):
            assert torch.equal(pk.pack_yshell_pallas(blk, 2, 3), pk.pack_yshell_pallas_plain(blk, 2, 3))
            slab = _rand(tuple(ext), 92 + 2 * rep + i, dev)
            assert torch.equal(pk.pallas_unpack_slab(blk.clone(), slab, pos, ext),
                               pk.pallas_unpack_slab_plain(blk.clone(), slab, pos, ext))
            assert torch.equal(pk.pallas_pack_slab(blk, pos, ext), pk.pallas_pack_slab_plain(blk, pos, ext))
            buf = _rand(pk.yshell_buffer_shape(tuple(blk.shape), 3), 96 + 2 * rep + i, dev)
            assert torch.equal(pk.unpack_yshell_pallas(blk.clone(), buf, 2, 3),
                               pk.unpack_yshell_pallas_plain(blk.clone(), buf, 2, 3))


def test_descriptor_launches_run_on_the_current_stream(dev):
    """Under ``torch.cuda.stream(s)`` the four kernels run on ``s``: they
    see a write queued on ``s`` behind a long sleep, and ``s.synchronize()``
    is enough to read their results."""
    block = torch.zeros(64, 66, 70, device=dev)
    slab = torch.zeros(60, 62, 3, device=dev)
    blocks = torch.zeros(3, 64, 66, 70, device=dev)
    target = torch.zeros(3, 64, 66, 70, device=dev)
    ybuf = torch.zeros(3, 3, 64, 70, device=dev)
    s = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)  # tens of ms: a kernel on another stream would run first
        slab.fill_(7.0)
        blocks.fill_(5.0)
        ybuf.fill_(3.0)
        pk.pallas_unpack_slab(block, slab, Dim3(2, 2, 60), Dim3(60, 62, 3))
        buf = pk.pack_yshell_pallas(blocks, 3, 3)
        packed = pk.pallas_pack_slab(blocks[1], Dim3(2, 2, 60), Dim3(60, 62, 3))
        pk.unpack_yshell_pallas(target, ybuf, 10, 3)
    s.synchronize()
    assert bool((block[2:62, 2:64, 60:63] == 7).all()) and float(block.sum()) == 7 * 60 * 62 * 3
    assert bool((buf == 5).all()) and bool((packed == 5).all())
    assert bool((target[:, :, 10:13] == 3).all()) and float(target.sum()) == 3 * ybuf.numel()


def test_descriptor_wrappers_refuse_on_cuda(dev):
    """Every refusal the CPU tests pin raises on CUDA tensors too, with its
    message, cached geometry or not."""
    block = torch.zeros(6, 6, 6, device=dev)

    def z(*shape, **kw):
        return torch.zeros(*shape, device=dev, **kw)

    pk.pallas_unpack_slab(block, z(2, 2, 2), (0, 0, 0), (2, 2, 2))  # cache the geometries
    pk.pack_yshell_pallas(block, 0, 1)
    pk.pallas_pack_slab(block, (0, 0, 0), (1, 1, 1))
    pk.unpack_yshell_pallas(block, z(1, 6, 6), 0, 1)
    cases = [
        (TypeError, "1/2/4/8-byte", lambda: pk.pallas_unpack_slab(
            block.to(torch.complex128), z(1, 1, 1, dtype=torch.complex128), (0, 0, 0), (1, 1, 1))),
        (ValueError, "leaves block", lambda: pk.pallas_unpack_slab(block, z(3, 1, 1), (4, 0, 0), (3, 1, 1))),
        (ValueError, "slab shape", lambda: pk.pallas_unpack_slab(block, z(2, 2, 2), (0, 0, 0), (2, 2, 3))),
        (TypeError, "slab dtype", lambda: pk.pallas_unpack_slab(block, z(2, 2, 2, dtype=torch.float64), (0, 0, 0),
                                                                (2, 2, 2))),
        (ValueError, "slab must be C-contiguous", lambda: pk.pallas_unpack_slab(block, z(2, 2, 4)[:, :, ::2],
                                                                                (0, 0, 0), (2, 2, 2))),
        (ValueError, "block must be C-contiguous", lambda: pk.pallas_unpack_slab(
            block.transpose(0, 2), z(2, 2, 2), (0, 0, 0), (2, 2, 2))),
        (ValueError, "different devices", lambda: pk.pallas_unpack_slab(block, torch.zeros(2, 2, 2), (0, 0, 0),
                                                                        (2, 2, 2))),
        (TypeError, "slab must be a torch.Tensor", lambda: pk.pallas_unpack_slab(
            block, np.zeros((2, 2, 2), np.float32), (0, 0, 0), (2, 2, 2))),
        (ValueError, "does not fit", lambda: pk.pack_yshell_pallas(block, 5, 2)),
        (TypeError, "1/2/4/8-byte", lambda: pk.pack_yshell_pallas(block.to(torch.complex128), 0, 1)),
        (ValueError, "block must be C-contiguous", lambda: pk.pack_yshell_pallas(block.transpose(0, 2), 0, 1)),
        (ValueError, "buf shape", lambda: pk.unpack_yshell_pallas(block, z(2, 6, 6), 0, 1)),
        (TypeError, "1/2/4/8-byte", lambda: pk.pallas_pack_slab(block.to(torch.complex128), (0, 0, 0), (1, 1, 1))),
        (ValueError, "leaves block", lambda: pk.pallas_pack_slab(block, (4, 0, 0), (3, 1, 1))),
        (ValueError, "block must be C-contiguous", lambda: pk.pallas_pack_slab(block.transpose(0, 2), (0, 0, 0),
                                                                               (1, 1, 1))),
        (ValueError, "does not fit", lambda: pk.unpack_yshell_pallas(block, z(2, 6, 6), 5, 2)),
        (TypeError, "buf dtype", lambda: pk.unpack_yshell_pallas(block, z(1, 6, 6, dtype=torch.float64), 0, 1)),
        (ValueError, "buf must be C-contiguous", lambda: pk.unpack_yshell_pallas(block, z(1, 6, 6).transpose(1, 2),
                                                                                 0, 1)),
        (ValueError, "block must be C-contiguous", lambda: pk.unpack_yshell_pallas(block.transpose(0, 2), z(1, 6, 6),
                                                                                   0, 1)),
        (ValueError, "different devices", lambda: pk.unpack_yshell_pallas(block, torch.zeros(1, 6, 6), 0, 1)),
        (TypeError, "buf must be a torch.Tensor", lambda: pk.unpack_yshell_pallas(
            block, np.zeros((1, 6, 6), np.float32), 0, 1)),
    ]
    counters = (pk.pallas_pack_slab, pk.pallas_unpack_slab, pk.pack_yshell_pallas, pk.unpack_yshell_pallas)
    before = [f.launches for f in counters]
    for exc, match, call in cases:
        with pytest.raises(exc, match=match):
            call()
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("lo,hi", [((1, 1, 1), (1, 1, 1)), ((1, 2, 3), (3, 1, 2))])
def test_mean6_plane_kernel_equals_plain(dev, lo, hi):
    from stencil_tpu_torch.ops import plane_stencil as ps

    block = _rand((37, 41, 70), 90, dev)
    before = ps.mean6_plane_step.launches
    got = ps.mean6_plane_step(block, lo, hi)
    torch.cuda.synchronize()
    assert ps.mean6_plane_step.launches == before + 1
    assert torch.equal(got, ps.mean6_plane_step_plain(block, lo, hi))


def _mean6_shape(m: int, s: int, late: bool, storage: str = "native") -> tuple:
    """A block on which the first march's tiles (32 x 64 with an apron of its
    depth d a side) and its x chunks end one cell late (``late``: one more
    row, column and plane than whole tiles and chunks) or one early.  The
    x chunking is the card's (``mean6_wavefront_launch`` of the build of
    ``storage``), so the x extent is found by asking for the plan."""
    from stencil_tpu_torch.ops import plane_stencil as ps

    d = m if m <= 4 else -(-m // 2)
    o = s - (m - d)  # the first march's output region starts here
    dl = 1 if late else -1
    Y, Z = 2 * o + 3 * (32 - 2 * d) + dl, 2 * o + 2 * (64 - 2 * d) + dl
    for X in range(2 * s + 3, 2 * s + 400):
        plan = ps.mean6_wavefront_launch((X, Y, Z), m, s, storage)
        last = (X - 2 * o) - (plan["nchunks"] - 1) * plan["xchunk"]
        if plan["xchunk"] >= 3 and last == (1 if late else plan["xchunk"] - 1):
            return X, Y, Z
    raise AssertionError(f"no x extent ends a chunk {'late' if late else 'early'} at m={m} s={s}")


@pytest.mark.parametrize("late", [False, True])
@pytest.mark.parametrize("m,s", [(m, s) for m in range(1, 9) for s in (m, m + 1)] + [(1, 3), (3, 8)])
def test_mean6_wavefront_kernel_equals_plain(dev, m, s, late):
    """Every m = 1..8 (one march, or two through the scratch) and s >= m, on
    blocks whose tiles and x chunks end one cell early or late; the valid
    interior [s, ext - s), the only region the kernel writes."""
    from stencil_tpu_torch.ops import plane_stencil as ps

    shape = _mean6_shape(m, s, late)
    raw = _rand(shape, 91, dev)
    before = ps.mean6_shell_wavefront_step.launches
    got = ps.mean6_shell_wavefront_step(raw, m, s)
    torch.cuda.synchronize()
    assert ps.mean6_shell_wavefront_step.launches == before + 1  # m levels in one call
    S = slice(s, -s)
    assert torch.equal(got[S, S, S], ps.mean6_shell_wavefront_step_plain(raw, m, s)[S, S, S]), shape
    plan = ps.mean6_wavefront_launch(shape, m, s)
    assert plan["launches"] == jk.wavefront_marches(m) and plan["smem_bytes"] == ps.mean6_wavefront_smem_bytes(m)


def test_mean6_wavefront_kernel_at_the_main_path_shape(dev):
    """Phase 15's call, 518^3 at m = 3, s = 3, and its plan: one march that
    fills the card from one block by cutting x into chunks."""
    from stencil_tpu_torch.ops import plane_stencil as ps

    raw = _rand((518, 518, 518), 92, dev)
    got = ps.mean6_shell_wavefront_step(raw, 3, 3)
    torch.cuda.synchronize()
    S = slice(3, -3)
    assert torch.equal(got[S, S, S], ps.mean6_shell_wavefront_step_plain(raw, 3, 3)[S, S, S])
    plan = ps.mean6_wavefront_launch((518, 518, 518), 3, 3)
    assert (plan["launches"], plan["depth"], plan["tiles_z"], plan["tiles_y"]) == (1, 3, 9, 20)
    assert plan["waves"] >= 4


def test_astaroth_packed_routes_agree_on_card(dev):
    """The plane route under every exchange route, 2 quantities on 2x2x2:
    bitwise equal to direct; the pallas routes launch the pack kernels."""
    from stencil_tpu_torch.kernels import ledger
    from stencil_tpu_torch.ops.exchange import EXCHANGE_ROUTES

    fields = {}
    for route in EXCHANGE_ROUTES:
        m = AstarothSim(32, 32, 32, num_quantities=2, subdomains=8, kernel_impl="cuda",
                        schedule="per-step", exchange_route=route)
        m.realize()
        ledger.reset_launch_counts()
        m.step(5)
        counts = ledger.launch_counts()
        fields[route] = [m.field(i) for i in range(2)]
        want = 2 * 2 * 5 if route.endswith("pallas") else 0  # 2 fields x 2 directions a step
        assert counts["pack_zshell_pallas"] == counts["unpack_zshell_pallas"] == want
        assert counts["pack_yshell_pallas"] == (want if route == "yzpack_pallas" else 0)
    for route in EXCHANGE_ROUTES[1:]:
        for got, ref in zip(fields[route], fields["direct"]):
            assert np.array_equal(got, ref), route


# --- the stream kernels: traced user kernels, emitted into csrc/stream_*.cu -----------


def _mean6(views, info):
    return {n: (v.sh(-1, 0, 0) + v.sh(0, -1, 0) + v.sh(0, 0, -1) + v.sh(1, 0, 0) + v.sh(0, 1, 0)
                + v.sh(0, 0, 1)) / 6.0 for n, v in views.items()}


def _k27(views, info):
    src, acc = views["u"], 0.0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                acc = acc + src.sh(dx, dy, dz) / (2.0 ** (abs(dx) + abs(dy) + abs(dz)))
    return {"u": acc / 8.0}


def _forced(views, info):
    src = views["u"]
    cx, cy, cz = info.coords()
    g = info.global_size
    val = (src.sh(1, 0, 0) + src.sh(-1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, -1, 0)) / 4.0
    d2 = (cx - g.x // 2) ** 2 + (cy - g.y // 2) ** 2 + (cz - g.z // 2) ** 2
    return {"u": torch.where(d2 < 9, 1.0, val * info.level)}


def _vc(views, info):
    u, c = views["u"], views["c"]
    lap = (u.sh(-1, 0, 0) + u.sh(1, 0, 0) + u.sh(0, -1, 0) + u.sh(0, 1, 0) + u.sh(0, 0, -1)
           + u.sh(0, 0, 1) - 6.0 * u.center())
    return {"u": u.center() + c.center() * lap}


def _r2(views, info):
    s = views["u"]
    return {"u": (s.sh(-2, 0, 0) + s.sh(2, 0, 1) + s.sh(0, -2, 1) + s.sh(1, 2, 0) + s.sh(0, 0, -2)
                  + s.sh(-1, 0, 2)) / 6.0}


def _xdiag(views, info):
    """Two joint fields that read x+-1 off the centre (the general form)."""
    u, c = views["u"], views["c"]
    return {"u": (u.sh(1, 1, 0) + c.sh(-1, 0, 1) + u.sh(0, -1, -1)) / 3.0, "c": c.sh(-1, 0, 0) * 0.5 + u.center()}


STREAM_KERNELS = {"mean6": (_mean6, ["a", "b"]), "k27": (_k27, ["u"]), "forced": (_forced, ["u"]),
                  "vc": (_vc, ["u", "c"]), "xdiag": (_xdiag, ["u", "c"])}


#: the global size of the fused wavefront cases (any: a library does not
#: depend on it)
_FUSED_GS = (2 * 61 - 3, 100, 2 * 77 - 9)


def _fused_bufs(n, X, Y, Z, lo, hi, nf, seed, dev):
    """Random fused shell buffers (``fused_shell_exchange``'s layouts)."""
    return ([_rand((n, lo.x + hi.x, Y, Z), seed + q, dev) for q in range(nf)],
            [_rand((n, lo.y + hi.y, X, Z), seed + 10 + q, dev) for q in range(nf)],
            [_rand((n, lo.z + hi.z, Y, X), seed + 20 + q, dev) for q in range(nf)])


def _wavefront_gs(s, slabs):
    return (2 * (90 - 2 * s) + 3, 2 * (70 - 2 * s), 2 * ((127 if slabs else 130) - 2 * s))


@pytest.fixture(scope="module")
def stream_libs():
    """The card, with every stream library the tests below launch built up
    front, one nvcc each, all at once (a lazy build would run them one by
    one; a library does not depend on the global size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from stencil_tpu_torch.kernels import build
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    want = []
    for kern, names in STREAM_KERNELS.values():
        want.append(("stream_wrap", st._source(StreamKernel(kern, names, 1, (18, 20, 70)), "stream_wrap",
                                                st._WRAP_LEVELS)))
        want.append(("stream_plane", st._source(StreamKernel(kern, names, 1, (30, 40, 140)),
                                                 "stream_plane", [1])))
        for m, s in ((1, 1), (2, 3), (3, 3)):
            for slabs in (False, True):
                sk = StreamKernel(kern, names, 1, _wavefront_gs(s, slabs))
                want.append(("stream_wavefront", st._source(sk, *st._wavefront_variant(m))))
    want.append(("stream_plane", st._source(StreamKernel(_r2, ["u"], 2, (30, 40, 140)), "stream_plane", [1])))
    # the fused forms (STP_FUSED) of the plane and the plain wavefront
    for kern, names in list(STREAM_KERNELS.values()) + [(_r2, ["u"])]:
        r = 2 if kern is _r2 else 1
        want.append(("stream_plane_fused", st._source(StreamKernel(kern, names, r, (30, 40, 140)),
                                                       "stream_plane_fused", [1], st._FUSED)))
    for kern, names in STREAM_KERNELS.values():
        for m in (1, 2, 3):
            sk = StreamKernel(kern, names, 1, _FUSED_GS)
            want.append(("stream_wavefront_fused", st._source(sk, *st._wavefront_variant(m, True))))
    build.build_generated(dict.fromkeys(want))
    return torch.device("cuda")


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", sorted(STREAM_KERNELS))
def test_stream_wrap_kernel_equals_plain(stream_libs, name, k):
    dev = stream_libs
    kern, names = STREAM_KERNELS[name]
    gs = (18, 20, 70)
    blocks = [_rand(gs, 11 + q, dev) for q in range(len(names))]
    org = torch.zeros(3, dtype=torch.int32, device=dev)
    before = st.stream_wrap_pass.launches
    got = st.stream_wrap_pass(kern, names, blocks, k, org, gs)
    torch.cuda.synchronize()
    assert st.stream_wrap_pass.launches == before + k  # one level per launch
    for g, w in zip(got, st.stream_wrap_pass_plain(kern, names, blocks, k, org, gs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,r", [("mean6", 1), ("k27", 1), ("forced", 1), ("vc", 1), ("r2", 2)])
def test_stream_plane_kernel_equals_plain(stream_libs, name, r):
    dev = stream_libs
    kern, names = STREAM_KERNELS[name] if name in STREAM_KERNELS else (_r2, ["u"])
    lo, hi = Dim3(r, r + 1, r), Dim3(r + 1, r, r + 2)
    gs = (30, 40, 140)
    raws = [_rand((2, 17, 19, 70), 21 + q, dev) for q in range(len(names))]
    org = torch.tensor([[0, 0, 0], [13, 17, 60]], dtype=torch.int32, device=dev)
    before = st.stream_plane_pass.launches
    got = st.stream_plane_pass(kern, names, raws, lo, hi, r, org, gs)
    torch.cuda.synchronize()
    assert st.stream_plane_pass.launches == before + 1  # all blocks and fields in one launch
    for g, w in zip(got, st.stream_plane_pass_plain(kern, names, raws, lo, hi, r, org, gs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,s", [(1, 1), (2, 3), (3, 3)])
@pytest.mark.parametrize("slabs", [False, True])
@pytest.mark.parametrize("name", sorted(STREAM_KERNELS))
def test_stream_wavefront_kernel_equals_plain(stream_libs, name, m, s, slabs):
    """Ragged blocks (several tiles and x chunks), dead columns past z_valid
    in the slab form; compared on the valid region."""
    dev = stream_libs
    kern, names = STREAM_KERNELS[name]
    Xr, Yr, Zr = 90, 70, 130
    zv = 127 if slabs else Zr
    gs = _wavefront_gs(s, slabs)
    raws = [_rand((2, Xr, Yr, Zr), 31 + q, dev) for q in range(len(names))]
    zs = [_rand((2, Xr, 2 * s, Yr), 41 + q, dev) for q in range(len(names))] if slabs else None
    org = torch.tensor([[5, 0, 7], [gs[0] - 3, Yr - 2 * s, 0]], dtype=torch.int32, device=dev)
    kw = dict(z_slabs=zs, z_valid=zv if slabs else None)
    before = st.stream_wavefront_pass.launches
    got, got_z = st.stream_wavefront_pass(kern, names, raws, m, s, org, gs, **kw)
    torch.cuda.synchronize()
    assert st.stream_wavefront_pass.launches == before + 1  # m levels in one launch
    want, want_z = st.stream_wavefront_pass_plain(kern, names, raws, m, s, org, gs, **kw)
    S = slice(s, -s)
    for g, w in zip(got, want):
        assert torch.equal(g[:, S, S, s:zv - s], w[:, S, S, s:zv - s])
    for g, w in zip(got_z or [], want_z or []):
        assert torch.equal(g[:, S, :, S], w[:, S, :, S])


_FORM_GS = (2 * 61 - 3, 100, 2 * 77 - 9)


@pytest.mark.parametrize("m,s", [(1, 1), (2, 3), (3, 3)])
@pytest.mark.parametrize("slabs", [False, True])
@pytest.mark.parametrize("name", sorted(STREAM_KERNELS))
def test_stream_wavefront_forms_equal_plain(stream_libs, name, m, s, slabs):
    """Each kernel's wavefront form (the register queue where x+-1 is read at
    the centre, else the general form) at a second ragged shape, several
    tiles a side in either form: bitwise on the valid region; the launch the
    occupancy calculator sizes fills the card in whole x chunks."""
    from stencil_tpu_torch.ops.stream_trace import StreamKernel, x_reads_centred

    dev = stream_libs
    kern, names = STREAM_KERNELS[name]
    sk = StreamKernel(kern, names, 1, _FORM_GS)
    n, Xr, Yr, Zr = 1, 61 + s, 100, 77
    zv = Zr - 2 if slabs else Zr
    raws = [_rand((n, Xr, Yr, Zr), 51 + q, dev) for q in range(len(names))]
    zs = [_rand((n, Xr, 2 * s, Yr), 61 + q, dev) for q in range(len(names))] if slabs else None
    org = torch.tensor([[_FORM_GS[0] - 2, 7, 3]], dtype=torch.int32, device=dev)
    kw = dict(z_slabs=zs, z_valid=zv if slabs else None)
    plan = st.stream_wavefront_launch(sk, names, raws, m, s, _FORM_GS, **kw)
    assert plan["form"] == ("queue" if x_reads_centred([sk.trace(lv) for lv in range(1, m + 1)]) else "general")
    assert plan["blocks_per_sm"] >= 1 and plan["nchunks"] * plan["xchunk"] >= Xr - 2 * s
    assert plan["blocks"] == plan["tiles_z"] * plan["tiles_y"] * plan["nchunks"] * n and plan["tiles_y"] >= 2
    before = st.stream_wavefront_pass.launches
    got, got_z = st.stream_wavefront_pass(sk, names, raws, m, s, org, _FORM_GS, **kw)
    torch.cuda.synchronize()
    assert st.stream_wavefront_pass.launches == before + 1
    want, want_z = st.stream_wavefront_pass_plain(sk, names, raws, m, s, org, _FORM_GS, **kw)
    S = slice(s, -s)
    for g, w in zip(got, want):
        assert torch.equal(g[:, S, S, s:zv - s], w[:, S, S, s:zv - s])
    for g, w in zip(got_z or [], want_z or []):
        assert torch.equal(g[:, S, :, S], w[:, S, :, S])


@pytest.mark.parametrize("name,r", [("mean6", 1), ("k27", 1), ("forced", 1), ("vc", 1), ("r2", 2)])
@pytest.mark.parametrize("n,X,Y,Z", [(1, 17, 19, 70), (2, 17, 19, 70), (2, 7, 40, 9)])
def test_stream_plane_fused_kernel_equals_plain(stream_libs, name, r, n, X, Y, Z):
    """The fused form of #7 (the far launch and the band launch) on ragged
    blocks with a stale shell and random buffers, one field and joint
    fields, uneven shell widths, and short axes where the band is the whole
    axis: bitwise on every cell, shell included; the array form's counter
    is left alone."""
    dev = stream_libs
    kern, names = STREAM_KERNELS[name] if name in STREAM_KERNELS else (_r2, ["u"])
    lo, hi = Dim3(r, r + 1, r), Dim3(r + 1, r, r + 2)
    gs = (30, 40, 140)
    raws = [_rand((n, X, Y, Z), 121 + q, dev) for q in range(len(names))]
    fs = _fused_bufs(n, X, Y, Z, lo, hi, len(names), 131, dev)
    org = torch.tensor([[0, 0, 0], [13, 17, 60]][:n], dtype=torch.int32, device=dev)
    before = (st.stream_plane_pass.launches, st.stream_plane_pass.fused_launches)
    got = st.stream_plane_pass(kern, names, raws, lo, hi, r, org, gs, fused_shell=fs)
    torch.cuda.synchronize()
    assert (st.stream_plane_pass.launches, st.stream_plane_pass.fused_launches) == (before[0], before[1] + 1)
    for g, w in zip(got, st.stream_plane_pass_plain(kern, names, raws, lo, hi, r, org, gs, fused_shell=fs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,s", [(1, 1), (2, 3), (3, 3)])
@pytest.mark.parametrize("name", sorted(STREAM_KERNELS))
def test_stream_wavefront_fused_kernel_equals_plain(stream_libs, name, m, s):
    """The fused form of #8 in either form (the register queue where x+-1
    is read at the centre, else the general form), two ragged blocks with
    several tiles a side and x chunks: bitwise on the valid region."""
    from stencil_tpu_torch.ops.stream_trace import StreamKernel, x_reads_centred

    dev = stream_libs
    kern, names = STREAM_KERNELS[name]
    sk = StreamKernel(kern, names, 1, _FUSED_GS)
    n, Xr, Yr, Zr = 2, 61 + s, 100, 77
    s3 = Dim3(s, s, s)
    raws = [_rand((n, Xr, Yr, Zr), 151 + q, dev) for q in range(len(names))]
    fs = _fused_bufs(n, Xr, Yr, Zr, s3, s3, len(names), 161, dev)
    org = torch.tensor([[_FUSED_GS[0] - 2, 7, 3], [4, 90, 40]], dtype=torch.int32, device=dev)
    plan = st.stream_wavefront_launch(sk, names, raws, m, s, _FUSED_GS, fused=True)
    assert plan["form"] == ("queue" if x_reads_centred([sk.trace(lv) for lv in range(1, m + 1)]) else "general")
    assert plan["blocks"] == plan["tiles_z"] * plan["tiles_y"] * plan["nchunks"] * n and plan["tiles_y"] >= 2
    before = (st.stream_wavefront_pass.launches, st.stream_wavefront_pass.fused_launches)
    got, got_z = st.stream_wavefront_pass(sk, names, raws, m, s, org, _FUSED_GS, fused_shell=fs)
    torch.cuda.synchronize()
    assert got_z is None
    assert (st.stream_wavefront_pass.launches, st.stream_wavefront_pass.fused_launches) == (before[0], before[1] + 1)
    want, _ = st.stream_wavefront_pass_plain(sk, names, raws, m, s, org, _FUSED_GS, fused_shell=fs)
    S = slice(s, -s)
    for g, w in zip(got, want):
        assert torch.equal(g[:, S, S, S], w[:, S, S, S])


# --- the stream kernels' field dtypes: bf16 storage, float64, float32 with float64 ----------

#: the fields' storage dtypes of each dtype build (one field takes the last)
STREAM_DTYPES = {"bf16": (torch.bfloat16, torch.bfloat16), "f64": (torch.float64, torch.float64),
                 "mixed": (torch.float32, torch.float64)}
#: (dtype build, kernel): the 27-point and the coordinate-forced kernel, two
#: joint fields, and two joint fields read off the centre at x+-1; float32
#: with float64 takes the two-field kernels
DTYPE_CASES = [(dt, name) for dt in STREAM_DTYPES for name in ("k27", "forced", "mean6", "xdiag")
               if not (dt == "mixed" and len(STREAM_KERNELS[name][1]) == 1)]
_DTYPE_GS = (30, 40, 140)


def _dtypes(dt, names):
    return STREAM_DTYPES[dt][-len(names):]


def _rand_as(shape, seed, dev, dtype):
    """Seeded float64 values rounded to ``dtype`` (bf16 to nearest even)."""
    return torch.from_numpy(np.random.default_rng(seed).random(shape)).to(dtype).to(dev)


def _dtype_depths(dt, names):
    """The wavefront depths the shared-memory model lets these fields run."""
    item = st.ring_itemsize(_dtypes(dt, names))
    return [m for m in (1, 2, 3) if st.stream_smem_fits(m, len(names), item)]


def _counter(dt, fused=False):
    return ("fused_" if fused else "") + ("bf16" if dt == "bf16" else "f64") + "_launches"


@pytest.fixture(scope="module")
def dtype_libs():
    """The card, with every dtype build the tests below launch built up
    front, one nvcc each, all at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from stencil_tpu_torch.kernels import build
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    want = []
    for dt, name in DTYPE_CASES:
        kern, names = STREAM_KERNELS[name]
        sk = StreamKernel(kern, names, 1, _DTYPE_GS, dtypes=_dtypes(dt, names))
        want += [("stream_wrap", st._source(sk, "stream_wrap", st._WRAP_LEVELS)),
                 ("stream_plane", st._source(sk, "stream_plane", [1])),
                 ("stream_plane_fused", st._source(sk, "stream_plane_fused", [1], st._FUSED))]
        for m in _dtype_depths(dt, names):
            want += [("stream_wavefront", st._source(sk, *st._wavefront_variant(m))),
                     ("stream_wavefront_fused", st._source(sk, *st._wavefront_variant(m, True)))]
    build.build_generated(dict.fromkeys(want))
    return torch.device("cuda")


def _dtype_kernel(dt, name):
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    kern, names = STREAM_KERNELS[name]
    return StreamKernel(kern, names, 1, _DTYPE_GS, dtypes=_dtypes(dt, names)), names


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("dt,name", DTYPE_CASES)
def test_stream_dtype_wrap_kernel_equals_plain(dtype_libs, dt, name, k):
    """#6 under each dtype on a ragged periodic block: bitwise, one launch a
    level counted under its form (bf16: float32 sets between the first
    launch and the last), none under the float32 form."""
    dev = dtype_libs
    sk, names = _dtype_kernel(dt, name)
    blocks = [_rand_as((19, 21, 70), 211 + q, dev, d) for q, d in enumerate(sk.dtypes)]
    org = torch.tensor([3, 1, 2], dtype=torch.int32, device=dev)
    before = (st.stream_wrap_pass.launches, getattr(st.stream_wrap_pass, _counter(dt)))
    got = st.stream_wrap_pass(sk, names, blocks, k, org, _DTYPE_GS)
    torch.cuda.synchronize()
    assert (st.stream_wrap_pass.launches, getattr(st.stream_wrap_pass, _counter(dt))) == (before[0], before[1] + k)
    for g, w, b in zip(got, st.stream_wrap_pass_plain(sk, names, blocks, k, org, _DTYPE_GS), blocks):
        assert g.dtype == b.dtype and torch.equal(g, w)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n,X,Y,Z", [(2, 17, 19, 70), (2, 7, 40, 9)])
@pytest.mark.parametrize("dt,name", DTYPE_CASES)
def test_stream_dtype_plane_kernel_equals_plain(dtype_libs, dt, name, n, X, Y, Z, fused):
    """#7 under each dtype, array and fused forms, ragged blocks and uneven
    shells: bitwise on every cell, the shell's stored bits included."""
    dev = dtype_libs
    sk, names = _dtype_kernel(dt, name)
    lo, hi = Dim3(1, 2, 1), Dim3(2, 1, 3)
    raws = [_rand_as((n, X, Y, Z), 221 + q, dev, d) for q, d in enumerate(sk.dtypes)]
    org = torch.tensor([[0, 0, 0], [13, 17, 60]][:n], dtype=torch.int32, device=dev)
    fs = None
    if fused:
        fs = tuple([_rand_as((n, w, a, b), seed + q, dev, d) for q, d in enumerate(sk.dtypes)]
                   for seed, (w, a, b) in ((231, (lo.x + hi.x, Y, Z)), (241, (lo.y + hi.y, X, Z)),
                                           (251, (lo.z + hi.z, Y, X))))
    counter = _counter(dt, fused)
    before = getattr(st.stream_plane_pass, counter)
    got = st.stream_plane_pass(sk, names, raws, lo, hi, 1, org, _DTYPE_GS, fused_shell=fs)
    torch.cuda.synchronize()
    assert getattr(st.stream_plane_pass, counter) == before + 1
    for g, w in zip(got, st.stream_plane_pass_plain(sk, names, raws, lo, hi, 1, org, _DTYPE_GS, fused_shell=fs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("form", ["plain", "slabs", "fused"])
@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("dt,name", DTYPE_CASES)
def test_stream_dtype_wavefront_kernel_equals_plain(dtype_libs, dt, name, m, form):
    """#8 under each dtype in its queue or general form (by the kernel),
    plain, z-slab (a dead column past z_valid) and fused, on two ragged
    blocks with several tiles a side and x chunks: bitwise on the valid
    region and the emitted slabs, at the storage dtype."""
    from stencil_tpu_torch.ops.stream_trace import x_reads_centred

    dev = dtype_libs
    sk, names = _dtype_kernel(dt, name)
    if m not in _dtype_depths(dt, names):
        m = max(_dtype_depths(dt, names))  # two float64 fields at m = 3 do not fit: their deepest
    s = 3
    n, Xr, Yr, Zr = 2, 61 + s, 100, 77
    zv = Zr - 2 if form == "slabs" else Zr
    raws = [_rand_as((n, Xr, Yr, Zr), 261 + q, dev, d) for q, d in enumerate(sk.dtypes)]
    org = torch.tensor([[_DTYPE_GS[0] - 2, 7, 3], [4, 30, 40]], dtype=torch.int32, device=dev)
    kw = {}
    if form == "slabs":
        kw = dict(z_slabs=[_rand_as((n, Xr, 2 * s, Yr), 271 + q, dev, d) for q, d in enumerate(sk.dtypes)],
                  z_valid=zv)
    if form == "fused":
        kw = dict(fused_shell=tuple([_rand_as((n, 2 * s, a, b), seed + q, dev, d) for q, d in enumerate(sk.dtypes)]
                                    for seed, (a, b) in ((281, (Yr, Zr)), (291, (Xr, Zr)), (301, (Yr, Xr)))))
    plan = st.stream_wavefront_launch(sk, names, raws, m, s, _DTYPE_GS, z_slabs=kw.get("z_slabs"),
                                      z_valid=kw.get("z_valid"), fused=form == "fused")
    assert plan["form"] == ("queue" if x_reads_centred([sk.trace(lv) for lv in range(1, m + 1)]) else "general")
    counter = _counter(dt, form == "fused")
    before = getattr(st.stream_wavefront_pass, counter)
    got, got_z = st.stream_wavefront_pass(sk, names, raws, m, s, org, _DTYPE_GS, **kw)
    torch.cuda.synchronize()
    assert getattr(st.stream_wavefront_pass, counter) == before + 1
    want, want_z = st.stream_wavefront_pass_plain(sk, names, raws, m, s, org, _DTYPE_GS, **kw)
    S = slice(s, -s)
    for g, w, r in zip(got, want, raws):
        assert g.dtype == r.dtype and torch.equal(g[:, S, S, s:zv - s], w[:, S, S, s:zv - s])
    for g, w in zip(got_z or [], want_z or []):
        assert torch.equal(g[:, S, :, S], w[:, S, :, S])


@pytest.mark.parametrize("dt", sorted(STREAM_DTYPES))
@pytest.mark.parametrize("schedule,part", [("auto", None), ("per-step", (2, 2, 2)), ("wavefront", (2, 2, 2))])
def test_stream_dtype_routes_captured_on_card(dev, dt, schedule, part):
    """A bf16, float64 and mixed domain through the stream engine's routes,
    captured against uncaptured: bitwise, the launches under the dtype's
    form counters and none under the float32 ones."""
    from stencil_tpu_torch.core.radius import Radius
    from stencil_tpu_torch.domain import DistributedDomain
    from stencil_tpu_torch.kernels import ledger

    outs = []
    for capture in (False, True):
        dd = DistributedDomain(36, 36, 36)
        dd.set_radius(Radius.constant(3))
        if part is not None:
            dd.set_partition(*part)
        hs = [dd.add_data(f"q{q}", dtype=torch.float32 if dt == "bf16" else d)
              for q, d in enumerate(STREAM_DTYPES[dt])]
        if dt == "bf16":
            dd.set_storage("bf16")
        dd.realize()
        rng = np.random.default_rng(7)
        for h in hs:
            dd.set_quantity(h, rng.random((36, 36, 36)))
        dd.set_capture(capture)
        path = {"auto": "auto", "per-step": "plane", "wavefront": "wavefront"}[schedule]
        step = dd.make_step(_mean6, engine="stream", x_radius=1, stream_path=path)
        ledger.reset_launch_counts()
        dd.run_step(step, 5)
        dd.run_step(step, 4)
        torch.cuda.synchronize()
        counts = ledger.launch_counts()
        kernel = f"stream_{step._stream_plan['route']}_pass"
        assert counts[kernel] == 0 and counts[f"{kernel}_{'bf16' if dt == 'bf16' else 'f64'}"] > 0
        outs.append([dd.quantity_to_host(h) for h in hs])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


def _stream_domain(size, route, mult, nf=2, seed=5):
    from stencil_tpu_torch.core.radius import Radius
    from stencil_tpu_torch.domain import DistributedDomain

    dd = DistributedDomain(*size)
    dd.set_radius(Radius.constant(1))
    dd.set_partition(2, 2, 2)
    dd.set_exchange_route(route)
    if mult > 1:
        dd.set_halo_multiplier(mult)
    hs = [dd.add_data(f"q{i}") for i in range(nf)]
    dd.realize()
    rng = np.random.default_rng(seed)
    for h in hs:
        dd.set_quantity(h, rng.random(size).astype(np.float32))
    return dd, hs


@pytest.mark.parametrize("path,mult,steps", [("plane", 1, 3), ("plane", 2, 3), ("auto", 3, 7)])
@pytest.mark.parametrize("route", ["yzpack_xla", "yzpack_pallas"])
def test_fused_steps_equal_array_on_card(dev, path, mult, steps, route):
    """halo="fused" against halo="array" on 2x2x2, the plane route (shell 1
    and 2) and the plain wavefront (m = 3, two macros and a remainder): the
    plane route's raw blocks bitwise, shell included, the wavefront's
    interiors (its shell is unwritten on the card in both forms); no unpack
    and no blend launch under fused, only the fused forms."""
    from stencil_tpu_torch.kernels import ledger

    runs = []
    for halo in ("array", "fused"):
        dd, hs = _stream_domain((36, 36, 36), route, mult)
        step = dd.make_step(_mean6, engine="stream", stream_path=path, stream_halo=halo, stream_z_slabs=False)
        assert step._stream_plan["halo"] == halo
        ledger.reset_launch_counts()
        dd.run_step(step, steps)
        torch.cuda.synchronize()
        runs.append((dd, hs, step, ledger.launch_counts()))
    (da, ha, sa, ca), (db, hb_, sb, cb) = runs
    kernel = f"stream_{sa._stream_plan['route']}_pass"
    assert ca[kernel] > 0 and ca[kernel + "_fused"] == 0
    assert cb[kernel + "_fused"] == ca[kernel] and cb[kernel] == 0
    assert not any(cb[k] for k in ("unpack_zshell_pallas", "unpack_yshell_pallas", "blend_slab", "blend_slab_dynamic"))
    if route == "yzpack_pallas":
        assert cb["pack_zshell_pallas"] == cb["pack_yshell_pallas"] == 2 * 2 * ca[kernel]
    for x, y in zip(ha, hb_):
        if sa._stream_plan["route"] == "plane":
            assert torch.equal(da.get_curr(x), db.get_curr(y))
        assert np.array_equal(da.quantity_to_host(x), db.quantity_to_host(y))


@pytest.mark.parametrize("size", [(36, 36, 36), (35, 33, 31)])
@pytest.mark.parametrize("path,mult,steps", [("plane", 1, 3), ("plane", 2, 3), ("auto", 3, 7)])
@pytest.mark.parametrize("route", ["direct", "yzpack_pallas"])
def test_split_steps_equal_off_on_card(dev, path, mult, steps, route, size):
    """overlap="split" (the exchange on a second stream, six narrow band
    passes over 3w-wide sub-blocks) against overlap="off" on 2x2x2, even
    and uneven sizes: the interiors bitwise."""
    outs = []
    for overlap in ("off", "split"):
        dd, hs = _stream_domain(size, route, mult)
        step = dd.make_step(_mean6, engine="stream", stream_path=path, stream_overlap=overlap,
                            stream_z_slabs=False)
        assert step._stream_plan["overlap"] == overlap
        dd.run_step(step, steps)
        outs.append([dd.quantity_to_host(h) for h in hs])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("size", [(36, 36, 36), (35, 33, 31)])
def test_torch_engine_overlap_equals_off_on_card(dev, size):
    """make_step(overlap=True): the interior beside the exchange on a second
    stream, then the exterior slabs; bitwise equal to overlap=False."""
    outs = []
    for overlap in (False, True):
        dd, hs = _stream_domain(size, "direct", 1)
        dd.run_step(dd.make_step(_mean6, overlap=overlap), 4)
        outs.append([dd.quantity_to_host(h) for h in hs])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", SWEEP_DTYPES)
def test_blend_slab_kernel_alignment_sweep(dev, dtype):
    """blend_slab on its descriptor path: one block and n = 3 and 8, odd Z
    (rows on both sides of the row kernel's 512-byte threshold), widths 1-3
    and the whole axis at odd and even positions, block and slab pointers
    shifted so that rows start at every offset mod 16.  Every cell outside
    the slab keeps its value."""
    cases = [(lead + (X, Y, Z), axis, r, pos, boff, soff)
             for lead, X, Y, Z in (((), 5, 6, 7), ((3,), 4, 5, 133), ((8,), 3, 4, 21), ((1,), 6, 3, 300),
                                   ((8,), 7, 9, 262))
             for axis in (0, 1, 2)
             for r, pos in ((1, 0), (2, 1), (3, (X, Y, Z)[axis] - 3), (1, (X, Y, Z)[axis] - 1), ((X, Y, Z)[axis], 0))
             for boff, soff in ((0, 0), (1, 1), (3, 0), (0, 5))]
    before = hb.blend_slab.launches
    for i, (shape, axis, r, pos, boff, soff) in enumerate(cases):
        sshape = list(shape)
        sshape[len(shape) - 3 + axis] = r
        block = _at_offset(shape, dtype, boff, 60_000 + i, dev)
        slab = _at_offset(tuple(sshape), dtype, soff, 70_000 + i, dev)
        want = hb.blend_slab_plain(block.clone(), slab, axis, pos)
        got = hb.blend_slab(block, slab, axis, pos)
        torch.cuda.synchronize()
        assert got is block
        assert torch.equal(got, want), (shape, axis, r, pos, boff, soff)
    assert hb.blend_slab.launches == before + len(cases)


def test_astaroth_routes_agree_on_card(dev):
    """wrap, plane and both wavefront forms on 1 and 8 subdomains against the
    torch engine, 2 quantities: bitwise."""
    runs = [AstarothSim(32, 32, 32, num_quantities=2)]
    for sub in (1, 8):
        for schedule in ("auto", "per-step", "wavefront"):
            runs.append(AstarothSim(32, 32, 32, num_quantities=2, subdomains=sub, kernel_impl="cuda",
                                    schedule=schedule))
    for m in runs:
        m.realize()
        m.step(7)
    for m in runs[1:]:
        for i in range(2):
            assert np.array_equal(m.field(i), runs[0].field(i))


def test_astaroth_uneven_routes_agree_on_card(dev):
    """31^3 over 2x2x2 (16 + 15 cells a side), auto (per-field plain
    wavefront) and per-step (plane), against one unpadded subdomain."""
    runs = [AstarothSim(31, 31, 31, num_quantities=2, kernel_impl="cuda")]
    for schedule in ("auto", "per-step"):
        runs.append(AstarothSim(31, 31, 31, num_quantities=2, kernel_impl="cuda", schedule=schedule))
        runs[-1].dd.set_partition(2, 2, 2)
    for m in runs:
        m.realize()
        m.step(7)
    assert runs[1]._step._stream_plan["route"] == "wavefront" and not runs[1]._step._stream_plan["z_slabs"]
    for m in runs[1:]:
        assert m.dd.padded()
        for i in range(2):
            assert np.array_equal(m.field(i), runs[0].field(i))


# --- the one-dispatch step loop: captured CUDA graphs ---------------------------------


def _jacobi_cap(size, part, captured, **kw):
    m = Jacobi3D(*size, kernel_impl="cuda", capture=captured, **kw)
    if part is not None:
        m.dd.set_partition(*part)
    m.realize()
    return m


def _astaroth_cap(size, part, captured, **kw):
    m = AstarothSim(*size, num_quantities=2, kernel_impl="cuda", capture=captured, **kw)
    if part is not None:
        m.dd.set_partition(*part)
    m.realize()
    return m


#: calls whose steps are and are not multiples of the unit, so that every
#: phase is captured and then replayed from either set of the ping-pong
_CAP_CALLS = (5, 7, 3, 8, 5)

_CAP_ROUTES = {
    "jacobi wrap": (_jacobi_cap, (32, 30, 28), None, dict(temporal_k=3)),
    "jacobi slab": (_jacobi_cap, (32, 32, 32), (2, 2, 2), dict(pallas_path="slab")),
    "jacobi shell": (_jacobi_cap, (32, 32, 32), (2, 2, 2), dict(pallas_path="shell")),
    "jacobi shell uneven": (_jacobi_cap, (33, 31, 32), (2, 2, 2), dict(pallas_path="shell")),
    "jacobi wavefront z-slab": (_jacobi_cap, (32, 32, 32), (2, 2, 2),
                                dict(pallas_path="wavefront", temporal_k=2, z_ring=False)),
    "jacobi wavefront z-ring": (_jacobi_cap, (32, 32, 256), (1, 1, 2), dict(pallas_path="wavefront", temporal_k=3)),
    "jacobi wavefront plain": (_jacobi_cap, (33, 31, 32), (2, 2, 2), dict(pallas_path="wavefront", temporal_k=2)),
    "astaroth wrap": (_astaroth_cap, (32, 32, 32), None, dict()),
    "astaroth wavefront 1x1x1": (_astaroth_cap, (32, 32, 32), None, dict(schedule="wavefront")),
    "astaroth wavefront": (_astaroth_cap, (32, 32, 32), (2, 2, 2), dict()),
    "astaroth wavefront uneven": (_astaroth_cap, (31, 31, 31), (2, 2, 2), dict()),
    "astaroth plane": (_astaroth_cap, (32, 32, 32), (2, 2, 2), dict(schedule="per-step")),
    **{f"astaroth plane {r}": (_astaroth_cap, (32, 32, 32), (2, 2, 2), dict(schedule="per-step", exchange_route=r))
       for r in ("zpack_xla", "zpack_pallas", "yzpack_xla", "yzpack_pallas")},
    "astaroth plane fused": (_astaroth_cap, (32, 32, 32), (2, 2, 2),
                             dict(schedule="per-step", exchange_route="yzpack_pallas", stream_halo="fused")),
    "astaroth wavefront fused": (_astaroth_cap, (32, 32, 32), (2, 2, 2),
                                 dict(exchange_route="yzpack_pallas", stream_halo="fused")),
    "astaroth plane split": (_astaroth_cap, (32, 32, 32), (2, 2, 2), dict(schedule="per-step", stream_overlap="split")),
    "astaroth wavefront split": (_astaroth_cap, (33, 31, 32), (2, 2, 2), dict(stream_overlap="split")),
    "astaroth torch engine": (lambda size, part, captured, **kw: _torch_engine_cap(size, part, captured),
                              (32, 32, 32), (2, 2, 2), dict()),
}


def _torch_engine_cap(size, part, captured):
    m = AstarothSim(*size, num_quantities=2, capture=captured)
    m.dd.set_partition(*part)
    m.realize()
    return m


def _fields_of(m):
    hs = [m.h] if hasattr(m, "h") else m.handles
    return [m.dd.quantity_to_host(h) for h in hs]


@pytest.mark.parametrize("name", sorted(_CAP_ROUTES))
def test_captured_route_equals_uncaptured_on_card(dev, name):
    """Each route with capture on against capture off, call by call: the
    valid interiors bitwise (the split output's shell is racy by contract,
    so interiors everywhere) and the launch counts equal; the captured step
    holds CUDA graphs, within its bound."""
    from stencil_tpu_torch.kernels import ledger

    make, size, part, kw = _CAP_ROUTES[name]
    cap, ref = make(size, part, True, **kw), make(size, part, False, **kw)
    for n in _CAP_CALLS:
        counts = []
        for m in (ref, cap):
            ledger.reset_launch_counts()
            m.step(n)
            torch.cuda.synchronize()
            counts.append(ledger.launch_counts())
        assert counts[0] == counts[1]
        for a, b in zip(_fields_of(ref), _fields_of(cap)):
            assert np.array_equal(a, b)
    loop = cap._step._loop
    assert cap._step.captured and loop.replays > 0
    assert len(loop.graphs) <= loop.max_graphs
    assert all(isinstance(g.impl, __import__("stencil_tpu_torch.ops.captured", fromlist=["x"]).CudaGraph)
               for g in loop.graphs.values())


@pytest.mark.parametrize("route", ["direct", "yzpack_pallas"])
@pytest.mark.parametrize("size", [(32, 32, 32), (33, 31, 32)])
def test_exchange_many_equals_exchanges_on_card(dev, route, size):
    """exchange_many(n): one captured exchange replayed n times, against n
    exchange() calls: the raw stacks bitwise, the launch counts equal."""
    from stencil_tpu_torch.kernels import ledger

    runs = []
    for many in (False, True):
        dd, hs = _stream_domain(size, route, 1)
        ledger.reset_launch_counts()
        if many:
            dd.exchange_many(5)
            dd.exchange_many(4)
        else:
            for _ in range(9):
                dd.exchange()
        torch.cuda.synchronize()
        runs.append((dd, hs, ledger.launch_counts()))
    (da, ha, ca), (db, hb_, cb) = runs
    assert ca == cb and sum(ca.values()) > 0
    for x, y in zip(ha, hb_):
        assert torch.equal(da.get_curr(x), db.get_curr(y))
    loop = db._exchange_loop
    assert loop.captured and loop.captures == 1 and loop.replays == 8  # 9 = the warm-up + 8 replays


def test_failed_capture_raises_without_fallback(dev):
    """A body that reads a value back to the host cannot be captured: the
    capture raises, no graph is kept, and a later call raises again rather
    than running the body uncaptured."""
    from stencil_tpu_torch.ops import captured

    calls = []

    def body(cur, nxt, depth):
        calls.append(depth)
        nxt.fields[0].copy_(cur.fields[0] + 1)
        if nxt.fields[0].sum().item() < 0:  # a host read: illegal while capturing
            raise AssertionError

    loop = captured.Loop(["q"], 1, body)
    curr = {"q": torch.zeros(8, device="cuda")}
    with pytest.raises(RuntimeError):
        loop.run(curr, 2, capture=True)
    assert not loop.graphs and calls == [1, 1]  # the warm-up, then the failed capture
    with pytest.raises(RuntimeError, match="could not be captured"):
        loop.run(curr, 1, capture=True)
    assert calls == [1, 1]
    torch.cuda.synchronize()
    # a model whose step cannot be captured raises from step() too
    m = _jacobi_cap((32, 32, 32), (2, 2, 2), True, pallas_path="shell")
    m._step._loop.body = body
    with pytest.raises(RuntimeError):
        m.step(2)
    torch.cuda.synchronize()


def test_graphs_freed_with_the_model(dev):
    """The graphs and their memory pool belong to the step: once the model is
    gone, the device memory is back where it was."""
    import gc
    import weakref

    def run():
        m = _astaroth_cap((32, 32, 32), (2, 2, 2), True, schedule="per-step", exchange_route="yzpack_pallas")
        m.step(3)
        m.step(3)
        torch.cuda.synchronize()
        return m

    del_and_collect = lambda: (gc.collect(), torch.cuda.synchronize(), torch.cuda.empty_cache())  # noqa: E731
    first = run()  # fills what outlives a model (built libraries, cached offsets)
    del first
    del_and_collect()
    base = torch.cuda.memory_reserved()
    m = run()
    graphs = [weakref.ref(g.impl) for g in m._step._loop.graphs.values()]
    assert graphs and torch.cuda.memory_reserved() > base
    del m
    del_and_collect()
    assert all(g() is None for g in graphs)
    assert torch.cuda.memory_reserved() <= base


# --- component (N-D) quantities and the debug oracles --------------------------------------


def _nd_domain(size, device, route="direct", quantities=(("v", (3,)), ("s", ())), radius=2, methods=None,
               grid=(2, 1, 4)):
    """A domain of ``quantities`` loaded with seeded fields (the same on
    every device for one size)."""
    import warnings

    from stencil_tpu_torch.core.radius import Radius
    from stencil_tpu_torch.domain import DistributedDomain

    dd = DistributedDomain(*size, device=device)
    dd.set_radius(Radius.face_edge_corner(radius, radius, radius))
    dd.set_partition(*grid)
    dd.set_exchange_route(route)
    if methods is not None:
        dd.set_methods(methods)
    hs = [dd.add_data(n, components=c) for n, c in quantities]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # a packed route on padded axes degrades
        dd.realize()
    for i, h in enumerate(hs):
        dd.set_quantity(h, np.random.default_rng(180 + i).random(h.components + size).astype(np.float32))
    return dd, hs


ND_ROUTES = ["direct", "zpack_xla", "zpack_pallas", "yzpack_xla", "yzpack_pallas"]


@pytest.mark.parametrize("size", [(32, 32, 32), (33, 31, 32)])
@pytest.mark.parametrize("route", ND_ROUTES)
def test_vector_exchange_every_route_on_card(dev, route, size):
    """A (3,) vector beside a scalar: the card's exchange (kernels #9-#14
    on the route's sweeps) equals the CPU's (their plain versions), each
    component equals a scalar domain's, and exchange_many equals repeated
    exchange() with equal launches."""
    from stencil_tpu_torch.kernels import ledger

    cpu, ch = _nd_domain(size, "cpu", route)
    cpu.exchange()
    runs = []
    for many in (False, True):
        dd, hs = _nd_domain(size, dev, route)
        ledger.reset_launch_counts()
        if many:
            dd.exchange_many(3)
        else:
            for _ in range(3):
                dd.exchange()
        torch.cuda.synchronize()
        runs.append((dd, hs, ledger.launch_counts()))
    (da, ha, ca), (db, hb_, cb) = runs
    assert ca == cb and sum(ca.values()) > 0
    if route.endswith("pallas") and size == (32, 32, 32):
        assert ca["pack_zshell_pallas"] > 0 and ca["unpack_zshell_pallas"] > 0
    if route == "yzpack_pallas" and size == (32, 32, 32):
        assert ca["pack_yshell_pallas"] > 0 and ca["unpack_yshell_pallas"] > 0
    if size != (32, 32, 32):
        assert ca["blend_slab_dynamic"] > 0
    for x, y, c in zip(ha, hb_, ch):
        assert torch.equal(da.get_curr(x), db.get_curr(y))
        assert torch.equal(da.get_curr(x).cpu(), cpu.get_curr(c))
    field = np.random.default_rng(180).random((3,) + size).astype(np.float32)  # _nd_domain's vector
    for c in range(3):
        sd, sh = _nd_domain(size, dev, route, quantities=(("q", ()),))
        sd.set_quantity(sh[0], field[c])
        sd.exchange()
        assert torch.equal(sd.get_curr(sh[0]), da.get_curr(ha[0])[c])


def _mean6_v(views, info):
    src = views["v"]
    return {"v": (src.sh(1, 0, 0) + src.sh(-1, 0, 0) + src.sh(0, 1, 0)
                  + src.sh(0, -1, 0) + src.sh(0, 0, 1) + src.sh(0, 0, -1)) / 6.0}


def _curl_v(views, info):
    v = views["v"]
    w0 = v.sh(0, 1, 0)[2] - v.sh(0, -1, 0)[2] - v.sh(0, 0, 1)[1] + v.sh(0, 0, -1)[1]
    w1 = v.sh(0, 0, 1)[0] - v.sh(0, 0, -1)[0] - v.sh(1, 0, 0)[2] + v.sh(-1, 0, 0)[2]
    w2 = v.sh(1, 0, 0)[1] - v.sh(-1, 0, 0)[1] - v.sh(0, 1, 0)[0] + v.sh(0, -1, 0)[0]
    s = views["s"].center()
    return {"v": v.center() + 0.5 * torch.stack([w0, w1, w2], dim=0), "s": s + v.center()[0] * 0.25}


@pytest.mark.parametrize("capture", [False, True])
@pytest.mark.parametrize("overlap", [True, False])
def test_vector_torch_engine_on_card(dev, overlap, capture):
    """The torch engine over a vector: the mean-of-6 step equals three
    scalar domains and the CPU run, and the component-mixing step equals
    the CPU run, captured or not, bitwise."""
    size = (32, 32, 32)
    outs = []
    for device in ("cpu", dev):
        dd, hs = _nd_domain(size, device, radius=1)
        dd.set_capture(capture and device != "cpu")
        step = dd.make_step(_mean6_v, overlap=overlap)
        dd.run_step(step, 2)
        dd.run_step(step, 2)
        mix = dd.make_step(_curl_v, overlap=overlap)
        dd.run_step(mix, 3)
        outs.append([dd.quantity_to_host(h) for h in hs])
        if device != "cpu" and capture:
            assert step.captured and mix.captured
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    dd, hs = _nd_domain(size, dev, radius=1)
    vec = dd.quantity_to_host(hs[0])
    dd.run_step(dd.make_step(_mean6_v, overlap=overlap), 4)
    got = dd.quantity_to_host(hs[0])
    for c in range(3):
        sd, sh = _nd_domain(size, dev, radius=1, quantities=(("v", ()),))
        sd.set_quantity(sh[0], vec[c])
        sd.run_step(sd.make_step(_mean6_v, overlap=overlap), 4)
        np.testing.assert_array_equal(sd.quantity_to_host(sh[0]), got[c])


@pytest.mark.parametrize("oracle", ["AllGather", "RollCompare"])
def test_oracles_on_card(dev, oracle):
    """Each debug oracle on the card equals the default exchange (on the
    card and on the CPU) and the other oracle, exchange() and
    exchange_many alike."""
    from stencil_tpu_torch.utils.config import MethodFlags

    quantities = (("a", ()), ("b", ()))
    size = (32, 32, 32)
    ref, rh = _nd_domain(size, "cpu", quantities=quantities)
    ref.exchange()
    for name in (oracle, "AllGather" if oracle == "RollCompare" else "RollCompare"):
        for many in (False, True):
            dd, hs = _nd_domain(size, dev, quantities=quantities, methods=getattr(MethodFlags, name))
            assert dd.exchange_route() == "direct"
            dd.exchange_many(2) if many else dd.exchange()
            for h, r in zip(hs, rh):
                assert torch.equal(dd.get_curr(h).cpu(), ref.get_curr(r))


# --- the kernel axes: bf16 storage and the tensor-core contraction (rows 1-5) ----------

#: the axis values other than f32 vpu: (compute unit, operands, bf16 storage)
AXIS_COMBOS = [("vpu", "f32", True), ("mxu", "f32", False), ("mxu_band", "f32", False), ("mxu", "bf16", False),
               ("mxu_band", "bf16", False), ("mxu", "f32", True), ("mxu_band", "bf16", True)]
#: the counter a launch of each combination moves
AXIS_COUNTER = {("vpu", "f32"): "bf16_launches", ("mxu", "f32"): "mxu_launches", ("mxu_band", "f32"): "mxu_launches",
                ("mxu", "bf16"): "mxu_bf16in_launches", ("mxu_band", "bf16"): "mxu_bf16in_launches"}


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest ulp distance of two float32 or bfloat16 tensors."""
    it, fold = (torch.int32, -(2 ** 31)) if a.dtype == torch.float32 else (torch.int16, -(2 ** 15))
    ai, bi = (t.contiguous().view(it).long() for t in (a, b))
    ai, bi = (torch.where(t < 0, fold - t, t) for t in (ai, bi))
    return int((ai - bi).abs().max())


def _hold_axis(got, want, unit, mi, bf16, levels):
    """bf16 storage on vpu bitwise; the contraction within 4 ulps a level
    (f32 operands) or tests/ulp.py's ``mxu_bf16_input_atol`` (bf16); on bf16
    storage the contraction within one bf16 ulp."""
    assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
    if unit == "vpu":
        assert torch.equal(got, want)
    elif bf16:
        assert _ulps(got, want) <= 1
    elif mi == "f32":
        assert _ulps(got, want) <= 4 * levels
    else:
        atol = levels * 4 * 2.0 ** -9 * float(want.abs().max())
        assert float((got.double() - want.double()).abs().max()) <= atol


def _axis_kw(unit, mi, bf16):
    return dict(compute_unit=unit, mxu_input=mi, f32_accumulate=bf16)


@pytest.mark.parametrize("unit,mi,bf16", AXIS_COMBOS)
@pytest.mark.parametrize("shape,k", [((66, 70, 130), k) for k in (1, 4, 5, 8, 12)]
                         + [((16, 5, 7), 4), ((9, 2, 1), 4)])
def test_axis_wrap_forms_hold_their_plain_versions(dev, shape, k, unit, mi, bf16):
    block = _rand(shape, 90 + k, dev).to(torch.bfloat16 if bf16 else torch.float32)
    keep = block.clone()
    counter = AXIS_COUNTER[unit, mi]
    before = getattr(jk.jacobi_wrap_step, counter)
    got = jk.jacobi_wrap_step(block, k, **_axis_kw(unit, mi, bf16))
    torch.cuda.synchronize()
    assert getattr(jk.jacobi_wrap_step, counter) == before + 1 and torch.equal(block, keep)
    _hold_axis(got, jk.jacobi_wrap_step_plain(block, k, **_axis_kw(unit, mi, bf16)), unit, mi, bf16, k)


@pytest.mark.parametrize("unit,mi,bf16", AXIS_COMBOS)
@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("form", ["ring", "slabs", "shell"])
def test_axis_wavefront_forms_hold_their_plain_versions(dev, form, m, unit, mi, bf16):
    """The deep cases' ragged blocks (both spheres cross them), one march
    (m <= 4) and two (m = 8, the scratch between them at f32)."""
    raw, org, d2, zs, gs, zv = _deep_args(dev, 3, m, m, form)
    dt = torch.bfloat16 if bf16 else torch.float32
    raw, zs = raw.to(dt), None if zs is None else zs.to(dt)
    S = slice(m, -m)
    kw = _axis_kw(unit, mi, bf16)
    if form == "ring":
        fn, plain, zsl = jk.jacobi_zring_wavefront_step, jk.jacobi_zring_wavefront_step_plain, slice(None)
        args, kw = (raw, m, org, d2, gs, zs), dict(kw, interior_offset=m)
    else:
        fn, plain, zsl = jk.jacobi_shell_wavefront_step, jk.jacobi_shell_wavefront_step_plain, slice(m, zv - m)
        args, kw = (raw, m, org, d2, gs), dict(kw, interior_offset=m, z_slabs=zs, z_valid=zv)
    counter = AXIS_COUNTER[unit, mi]
    before = getattr(fn, counter)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # a band on an untilable plane names the dense form
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        want = plain(*args, **kw)
    assert getattr(fn, counter) == before + 1
    if zs is None:
        got, want = (got,), (want,)
    _hold_axis(got[0][..., S, S, zsl], want[0][..., S, S, zsl], unit, mi, bf16, m)
    if zs is not None:
        _hold_axis(got[1][..., S, :, S], want[1][..., S, :, S], unit, mi, bf16, m)


@pytest.mark.parametrize("n,X,Y,Z", PLANE_CASES)
def test_bf16_plane_kernel_equals_plain(dev, n, X, Y, Z):
    gs = (60, Y + 1, Z + 2)
    blocks = _rand((n, X, Y, Z), 95, dev).to(torch.bfloat16)
    org = _crossing_origins(n, X, gs, dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (Y - 2, Z - 2), gs, dev) for o in org])
    before = jk.jacobi_plane_step.bf16_launches
    got = jk.jacobi_plane_step(blocks, org, d2, gs, f32_accumulate=True)
    torch.cuda.synchronize()
    assert jk.jacobi_plane_step.bf16_launches == before + 1
    assert torch.equal(got, jk.jacobi_plane_step_plain(blocks, org, d2, gs, f32_accumulate=True))


@pytest.mark.parametrize("n,X,Y,Z", SLAB_CASES)
def test_bf16_slab_kernel_equals_plain(dev, n, X, Y, Z):
    gs = (60, Y + 1, Z + 2)
    block = _rand((n, X, Y, Z), 96, dev).to(torch.bfloat16)
    slabs = [_rand((n,) + s, 97 + i, dev).to(torch.bfloat16)
             for i, s in enumerate(((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y)))]
    org = _crossing_origins(n, X, gs, dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (Y, Z), gs, dev) for o in org])
    before = jk.jacobi_slab_step.bf16_launches
    got = jk.jacobi_slab_step(block, *slabs, org, d2, gs, f32_accumulate=True)
    torch.cuda.synchronize()
    assert jk.jacobi_slab_step.bf16_launches == before + 1
    assert torch.equal(got, jk.jacobi_slab_step_plain(block, *slabs, org, d2, gs, f32_accumulate=True))


@pytest.mark.parametrize("unit,mi,bf16", AXIS_COMBOS)
def test_axis_forms_at_the_main_path_shapes(dev, unit, mi, bf16):
    """512^3 wrap at k = 8, the z-ring (8, 272, 272, 256) and shell (8,
    272^3) wavefronts at m = 8 with z slabs, as the routes call them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = _axis_kw(unit, mi, bf16)
    block = _rand((512, 512, 512), 98, dev).to(dt)
    _hold_axis(jk.jacobi_wrap_step(block, 8, **kw), jk.jacobi_wrap_step_plain(block, 8, **kw), unit, mi, bf16, 8)
    del block
    half, m, gs = 256, 8, (512, 512, 512)
    r = half + 2 * m
    org = torch.tensor([[x, y, z] for x in (0, half) for y in (0, half) for z in (0, half)], dtype=torch.int32,
                       device=dev)
    zs = _rand((8, r, 2 * m, r), 99, dev).to(dt)
    raw = _rand((8, r, r, half), 100, dev).to(dt)
    d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - m, int(o[2]), m, r, half, gs, dev) for o in org])
    got = jk.jacobi_zring_wavefront_step(raw, m, org, d2, gs, zs, **kw)
    want = jk.jacobi_zring_wavefront_step_plain(raw, m, org, d2, gs, zs, **kw)
    _hold_axis(got[0][:, m:-m, m:-m], want[0][:, m:-m, m:-m], unit, mi, bf16, m)
    _hold_axis(got[1][:, m:-m, :, m:-m], want[1][:, m:-m, :, m:-m], unit, mi, bf16, m)
    raw = _rand((8, r, r, r), 101, dev).to(dt)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - m, int(o[2]) - m, (r, r), gs, dev) for o in org])
    got = jk.jacobi_shell_wavefront_step(raw, m, org, d2, gs, z_slabs=zs, z_valid=r, **kw)
    want = jk.jacobi_shell_wavefront_step_plain(raw, m, org, d2, gs, z_slabs=zs, z_valid=r, **kw)
    S = slice(m, -m)
    _hold_axis(got[0][:, S, S, S], want[0][:, S, S, S], unit, mi, bf16, m)
    _hold_axis(got[1][:, S, :, S], want[1][:, S, :, S], unit, mi, bf16, m)


@pytest.mark.parametrize("mi", ["f32", "bf16"])
def test_mxu_forms_keep_non_finite_cells_outside_the_stencils(dev, mi):
    """A non-finite or huge value in a cell no valid cell reads (the dead
    columns past z_valid, the shell's outer planes and rows beyond the
    levels' reach) leaves the valid region finite and as the plain version
    has it with those cells at 0: the tile contraction multiplies them by
    exact zeros, so its loads take them as 0 (the plain version's dense band
    product, as the JAX package's, would spread them along their rows; a
    huge one would overflow a level later)."""
    m, s = 2, 4
    raw, org, d2, zs, gs, zv = _deep_args(dev, 2, m, s, "shell")
    clean = raw.clone()
    raw[..., zv:] = float("nan")
    raw[:, 1, :s - m] = float("inf")
    raw[:, 0, :s - m] = 3e38
    raw[:, :, -(s - m):] = float("nan")
    clean[..., zv:] = 0.0
    clean[:, :2, :s - m] = 0.0
    clean[:, :, -(s - m):] = 0.0
    kw = dict(interior_offset=s, z_valid=zv, compute_unit="mxu", mxu_input=mi)
    got = jk.jacobi_shell_wavefront_step(raw, m, org, d2, gs, **kw)
    want = jk.jacobi_shell_wavefront_step_plain(clean, m, org, d2, gs, **kw)
    S, zsl = slice(s, -s), slice(s, zv - s)
    assert torch.isfinite(want[:, S, S, zsl]).all()
    _hold_axis(got[:, S, S, zsl], want[:, S, S, zsl], "mxu", mi, False, m)


def _axis_model(size, grid, **kw):
    model = Jacobi3D(size, size, size, kernel_impl="cuda", **kw)
    if grid:
        model.dd.set_partition(2, 2, 2)
    model.realize()
    return model


@pytest.mark.parametrize("path,grid", [("wrap", False), ("wavefront", True), ("shell", True), ("slab", True)])
def test_axis_routes_on_card(dev, path, grid):
    """Each route under bf16 storage and (wrap, wavefront) the contraction
    against its f32 vpu run: tests/ulp.py's bounds, the launches in the
    form's counter, the field inside [COLD, HOT]."""
    from stencil_tpu_torch.kernels import ledger

    ref = _axis_model(64, grid, pallas_path=path)
    ref.step(16)
    want = torch.from_numpy(ref.temperature())
    kernel = {"wrap": "jacobi_wrap_step", "wavefront": "jacobi_zring_wavefront_step",
              "shell": "jacobi_plane_step", "slab": "jacobi_slab_step"}[path]
    if grid and path == "wavefront" and not ref._wavefront_z_ring:
        kernel = "jacobi_shell_wavefront_step"
    runs = [("bf16", {"storage_dtype": "bf16"})]
    if path in ("wrap", "wavefront"):
        runs += [("mxu", {"compute_unit": "mxu_band"}), ("mxu_bf16in", {"compute_unit": "mxu", "mxu_input": "bf16"})]
    for form, kw in runs:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            model = _axis_model(64, grid, pallas_path=path, **kw)
        ledger.reset_launch_counts()
        model.step(16)
        counts = ledger.launch_counts()
        got = torch.from_numpy(model.temperature())
        assert counts[f"{kernel}_{form}"] > 0 and counts[kernel] == 0, counts
        assert COLD_TEMP <= float(got.min()) and float(got.max()) <= HOT_TEMP
        if form == "bf16":
            calls = counts[f"{kernel}_{form}"]
            assert float((got - want).abs().max()) <= (calls + 1) * 2.0 ** -9
        elif form == "mxu":
            assert _ulps(got, want) <= 4 * 16
        else:
            assert float((got - want).abs().max()) <= 16 * 4 * 2.0 ** -9


def test_default_build_is_the_explicit_vpu_native_build_on_card(dev):
    a = _axis_model(64, True)
    b = _axis_model(64, True, compute_unit="vpu", mxu_input="f32", storage_dtype="native")
    a.step(12)
    b.step(12)
    assert np.array_equal(a.temperature(), b.temperature())


@pytest.mark.parametrize("kw", [{"storage_dtype": "bf16"}, {"compute_unit": "mxu_band", "mxu_input": "bf16"}])
@pytest.mark.parametrize("grid", [False, True])
def test_axis_capture_on_card(dev, kw, grid):
    """Captured against uncaptured under the axes: bitwise, launches equal."""
    from stencil_tpu_torch.kernels import ledger

    out = []
    for capture in (False, True):
        model = _axis_model(64, grid, capture=capture, **kw)
        ledger.reset_launch_counts()
        model.step(20)
        out.append((model.temperature(), ledger.launch_counts()))
    assert np.array_equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


# --- float64 fields on the Jacobi kernels; bf16 storage and float64 on the mean-of-6 kernels


def _f64(t):
    return None if t is None else t.double()


@pytest.mark.parametrize("shape,k", [((66, 70, 130), k) for k in (1, 2, 3, 4, 5, 6, 7, 8, 12)]
                         + [((16, 5, 7), 4), ((9, 2, 1), 4)])
def test_f64_wrap_kernel_equals_plain(dev, shape, k):
    block = _rand(shape, 110 + k, dev).double()
    keep = block.clone()
    before = (jk.jacobi_wrap_step.f64_launches, jk.jacobi_wrap_step.launches)
    got = jk.jacobi_wrap_step(block, k)
    torch.cuda.synchronize()
    assert (jk.jacobi_wrap_step.f64_launches, jk.jacobi_wrap_step.launches) == (before[0] + 1, before[1])
    assert torch.equal(block, keep) and got.dtype == torch.float64
    assert torch.equal(got, jk.jacobi_wrap_step_plain(block, k))


@pytest.mark.parametrize("m", [1, 4, 6, 8])
@pytest.mark.parametrize("form", ["ring", "slabs", "shell"])
def test_f64_wavefront_kernels_equal_plain(dev, form, m):
    """The deep cases' ragged blocks (both spheres cross them), one march
    (m <= 4) and two (m = 6, 8: the scratch between them at f64)."""
    raw, org, d2, zs, gs, zv = _deep_args(dev, 3, m, m, form)
    raw, zs = raw.double(), _f64(zs)
    S = slice(m, -m)
    if form == "ring":
        fn, plain, zsl = jk.jacobi_zring_wavefront_step, jk.jacobi_zring_wavefront_step_plain, slice(None)
        args, kw = (raw, m, org, d2, gs, zs), dict(interior_offset=m)
    else:
        fn, plain, zsl = jk.jacobi_shell_wavefront_step, jk.jacobi_shell_wavefront_step_plain, slice(m, zv - m)
        args, kw = (raw, m, org, d2, gs), dict(interior_offset=m, z_slabs=zs, z_valid=zv)
    before = (fn.f64_launches, fn.launches)
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert (fn.f64_launches, fn.launches) == (before[0] + 1, before[1])
    want = plain(*args, **kw)
    if zs is None:
        got, want = (got,), (want,)
    assert got[0].dtype == torch.float64
    assert torch.equal(got[0][..., S, S, zsl], want[0][..., S, S, zsl])
    if zs is not None:
        assert torch.equal(got[1][..., S, :, S], want[1][..., S, :, S])
    plan = jk.jacobi_wavefront_launch(tuple(raw.shape), m, ring=form == "ring", slabs=zs is not None,
                                      z_valid=None if form == "ring" else zv, storage="f64")
    assert plan["launches"] == jk.wavefront_marches(m) and plan["smem_bytes"] == jk.march_smem_bytes(m, 8)


@pytest.mark.parametrize("n,X,Y,Z", PLANE_CASES)
def test_f64_plane_kernel_equals_plain(dev, n, X, Y, Z):
    gs = (60, Y + 1, Z + 2)
    blocks = _rand((n, X, Y, Z), 115, dev).double()
    org = _crossing_origins(n, X, gs, dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (Y - 2, Z - 2), gs, dev) for o in org])
    before = jk.jacobi_plane_step.f64_launches
    got = jk.jacobi_plane_step(blocks, org, d2, gs)
    torch.cuda.synchronize()
    assert jk.jacobi_plane_step.f64_launches == before + 1
    assert torch.equal(got, jk.jacobi_plane_step_plain(blocks, org, d2, gs))


@pytest.mark.parametrize("n,X,Y,Z", SLAB_CASES)
def test_f64_slab_kernel_equals_plain(dev, n, X, Y, Z):
    gs = (60, Y + 1, Z + 2)
    block = _rand((n, X, Y, Z), 116, dev).double()
    slabs = [_rand((n,) + s, 117 + i, dev).double()
             for i, s in enumerate(((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y)))]
    org = _crossing_origins(n, X, gs, dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (Y, Z), gs, dev) for o in org])
    before = jk.jacobi_slab_step.f64_launches
    got = jk.jacobi_slab_step(block, *slabs, org, d2, gs)
    torch.cuda.synchronize()
    assert jk.jacobi_slab_step.f64_launches == before + 1
    assert torch.equal(got, jk.jacobi_slab_step_plain(block, *slabs, org, d2, gs))


_M6_DT = {"bf16": torch.bfloat16, "f64": torch.float64}


@pytest.mark.parametrize("dt", ["bf16", "f64"])
@pytest.mark.parametrize("late", [False, True])
@pytest.mark.parametrize("m", range(1, 9))
def test_mean6_dtype_wavefront_kernel_equals_plain(dev, dt, m, late):
    """Every m = 1..8 under bf16 storage and at f64, on blocks whose tiles
    and x chunks (the build's own plan) end one cell early or late."""
    from stencil_tpu_torch.ops import plane_stencil as ps

    shape = _mean6_shape(m, m, late, dt)
    raw = _rand(shape, 120 + m, dev).to(_M6_DT[dt])
    acc = dt == "bf16"
    before = getattr(ps.mean6_shell_wavefront_step, f"{dt}_launches")
    got = ps.mean6_shell_wavefront_step(raw, m, m, f32_accumulate=acc)
    torch.cuda.synchronize()
    assert getattr(ps.mean6_shell_wavefront_step, f"{dt}_launches") == before + 1
    S = slice(m, -m)
    want = ps.mean6_shell_wavefront_step_plain(raw, m, m, f32_accumulate=acc)
    assert got.dtype == raw.dtype and torch.equal(got[S, S, S], want[S, S, S]), shape
    plan = ps.mean6_wavefront_launch(shape, m, m, dt)
    assert plan["smem_bytes"] == ps.mean6_wavefront_smem_bytes(m, 8 if dt == "f64" else 4)


@pytest.mark.parametrize("dt", ["bf16", "f64"])
@pytest.mark.parametrize("lo,hi", [((1, 1, 1), (1, 1, 1)), ((1, 2, 3), (3, 1, 2)), ((3, 3, 3), (3, 3, 3))])
def test_mean6_dtype_plane_kernel_equals_plain(dev, dt, lo, hi):
    from stencil_tpu_torch.ops import plane_stencil as ps

    block = _rand((37, 41, 70), 130, dev).to(_M6_DT[dt])
    acc = dt == "bf16"
    before = getattr(ps.mean6_plane_step, f"{dt}_launches")
    got = ps.mean6_plane_step(block, lo, hi, f32_accumulate=acc)
    torch.cuda.synchronize()
    assert getattr(ps.mean6_plane_step, f"{dt}_launches") == before + 1
    assert got.dtype == block.dtype and torch.equal(got, ps.mean6_plane_step_plain(block, lo, hi, f32_accumulate=acc))


def test_f64_forms_at_the_main_path_shapes(dev):
    """512^3 wrap at k = 8; on 2x2x2 the z-ring (8, 264, 264, 256) and
    shell (8, 264^3) wavefronts at the f64 plan's m = 4 with z slabs."""
    block = _rand((512, 512, 512), 131, dev).double()
    assert torch.equal(jk.jacobi_wrap_step(block, 8), jk.jacobi_wrap_step_plain(block, 8))
    del block
    half, m, gs = 256, jk.wavefront_auto_depth(256, itemsize=8), (512, 512, 512)
    assert m == 4
    r = half + 2 * m
    org = torch.tensor([[x, y, z] for x in (0, half) for y in (0, half) for z in (0, half)], dtype=torch.int32,
                       device=dev)
    zs = _rand((8, r, 2 * m, r), 132, dev).double()
    raw = _rand((8, r, r, half), 133, dev).double()
    d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - m, int(o[2]), m, r, half, gs, dev) for o in org])
    got = jk.jacobi_zring_wavefront_step(raw, m, org, d2, gs, zs)
    want = jk.jacobi_zring_wavefront_step_plain(raw, m, org, d2, gs, zs)
    assert torch.equal(got[0][:, m:-m, m:-m], want[0][:, m:-m, m:-m])
    assert torch.equal(got[1][:, m:-m, :, m:-m], want[1][:, m:-m, :, m:-m])
    del got, want, raw
    plan = jk.jacobi_wrap_launch((512, 512, 512), 8, storage="f64")
    assert plan["blocks_per_sm"] >= 1 and plan["smem_bytes"] == jk.march_smem_bytes(4, 8) == 132_160


@pytest.mark.parametrize("path,grid,size", [("wrap", False, 64), ("wavefront", True, 64), ("shell", True, 64),
                                            ("slab", True, 64), ("auto", True, 63)])
def test_f64_routes_on_card(dev, path, grid, size):
    """Each route at f64 launches its f64 form only and equals the plain
    path (k = 1 wrap calls at f64) bitwise; the field inside [COLD, HOT]."""
    from stencil_tpu_torch.kernels import ledger

    ledger.reset_launch_counts()
    model = _axis_model(size, grid, pallas_path=path, dtype=torch.float64)
    model.step(10)
    counts = {k: v for k, v in ledger.launch_counts().items() if v}
    kernel = {"wrap": "jacobi_wrap_step", "shell": "jacobi_plane_step", "slab": "jacobi_slab_step",
              "wavefront": "jacobi_zring_wavefront_step" if model._wavefront_z_ring
              else "jacobi_shell_wavefront_step"}[model._pallas_path]
    assert counts.get(f"{kernel}_f64", 0) > 0 and kernel not in counts, counts
    got = model.temperature()
    ref = torch.full((size,) * 3, 0.5, dtype=torch.float64, device=dev)
    for _ in range(10):
        ref = jk.jacobi_wrap_step_plain(ref, 1)
    assert got.dtype == np.float64 and np.array_equal(got, ref.cpu().numpy())
    assert COLD_TEMP <= got.min() and got.max() <= HOT_TEMP


@pytest.mark.parametrize("grid", [False, True])
def test_f64_capture_on_card(dev, grid):
    from stencil_tpu_torch.kernels import ledger

    out = []
    for capture in (False, True):
        model = _axis_model(64, grid, capture=capture, dtype=torch.float64)
        ledger.reset_launch_counts()
        model.step(20)
        out.append((model.temperature(), ledger.launch_counts()))
    assert np.array_equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


# --- the contraction form of the stream and mean-of-6 kernels (rows 6-8, 17, 18) --------


def _m6_mxu(views, info):
    """Astaroth's ``_kernel_mxu``: the register-queue form of #8."""
    return {n: (v.sh(-1, 0, 0) + v.sh(1, 0, 0) + v.plane_nbr_sum()) / 6.0 for n, v in views.items()}


def _off_mxu(views, info):
    """x-1 read off the centre (the general form of #8) beside the sums."""
    u = views["u"]
    return {"u": u.sh(-1, 1, 0) * 0.25 + u.sh(1, 0, 0) * 0.25 + u.plane_nbr_sum() * 0.125}


def _one_mxu(views, info):
    """Two joint fields, only ``u`` contracted (STP_NBR_MASK 0x1)."""
    u, c = views["u"], views["c"]
    return {"u": (u.sh(-1, 0, 0) + u.sh(1, 0, 0) + u.plane_nbr_sum()) / 6.0, "c": c.center() * 0.5 + u.center() * 0.5}


MXU_KERNELS = {"m6": (_m6_mxu, ["a", "b"]), "off": (_off_mxu, ["u"]), "one": (_one_mxu, ["u", "c"])}
#: the contraction's axis values: (compute unit, operands, bf16 storage)
MXU_COMBOS = [combo for combo in AXIS_COMBOS if combo[0] != "vpu"]


def _mxu_sk(name, gs, mi, bf16):
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    kern, names = MXU_KERNELS[name]
    dts = [torch.bfloat16 if bf16 else torch.float32] * len(names)
    return StreamKernel(kern, names, 1, gs, dtypes=dts, compute_unit="mxu", mxu_input=mi)


_MXU_WRAP_SHAPES = [(18, 20, 70), (16, 5, 7), (9, 2, 1)]
_MXU_PLANE_CASES = [((2, 17, 19, 70), (1, 2, 1), (2, 1, 3)), ((1, 12, 70, 130), (1, 1, 1), (1, 1, 1)),
                    ((3, 7, 31, 63), (3, 3, 3), (3, 3, 3))]
_MXU_WF_CASES = [(1, 1), (2, 3), (3, 3)]


@pytest.fixture(scope="module")
def mxu_libs():
    """The card, with every contraction-form library the tests below launch
    built up front, one nvcc each, all at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from stencil_tpu_torch.kernels import build

    want = []
    for name in MXU_KERNELS:
        for mi in ("f32", "bf16"):
            for bf16 in (False, True):
                sk = _mxu_sk(name, (18, 20, 70), mi, bf16)
                want.append(("stream_wrap", st._source(sk, "stream_wrap", st._WRAP_LEVELS)))
                want.append(("stream_plane", st._source(sk, "stream_plane", [1])))
                want += [("stream_wavefront", st._source(sk, *st._wavefront_variant(m))) for m in (1, 2, 3)]
    build.build_generated(dict.fromkeys(want))
    build.build([n for n in build.SOURCES if n.startswith("jacobi_wavefront_mxu")] + ["plane_stencil"])
    return torch.device("cuda")


def _mxu_counter(mi):
    return "mxu_launches" if mi == "f32" else "mxu_bf16in_launches"


def _mxu_data(shape, seed, dev, bf16):
    return _rand(shape, seed, dev).to(torch.bfloat16 if bf16 else torch.float32)


@pytest.mark.parametrize("unit,mi,bf16", MXU_COMBOS)
@pytest.mark.parametrize("name", sorted(MXU_KERNELS))
@pytest.mark.parametrize("shape", _MXU_WRAP_SHAPES)
@pytest.mark.parametrize("k", [1, 3])
def test_mxu_stream_wrap_forms_hold_their_plain_versions(mxu_libs, name, shape, k, unit, mi, bf16):
    """#6's contraction form, ragged planes (a 2 x 1 plane wraps every
    neighbour onto one cell) and joint fields: within 4 ulps a level (f32
    operands), tests/ulp.py's bf16-input bound, or a bf16 ulp (bf16 storage)."""
    dev = mxu_libs
    kern, names = MXU_KERNELS[name]
    blocks = [_mxu_data(shape, 140 + q, dev, bf16) for q in range(len(names))]
    org = torch.zeros(3, dtype=torch.int32, device=dev)
    kw = dict(compute_unit=unit, mxu_input=mi)
    before = getattr(st.stream_wrap_pass, _mxu_counter(mi))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # a band on an untilable plane names the dense form
        got = st.stream_wrap_pass(kern, names, blocks, k, org, shape, **kw)
        torch.cuda.synchronize()
        want = st.stream_wrap_pass_plain(kern, names, blocks, k, org, shape, **kw)
    assert getattr(st.stream_wrap_pass, _mxu_counter(mi)) == before + k
    for g, w in zip(got, want):
        _hold_axis(g, w, unit, mi, bf16, k)


@pytest.mark.parametrize("unit,mi,bf16", MXU_COMBOS)
@pytest.mark.parametrize("name", sorted(MXU_KERNELS))
@pytest.mark.parametrize("shape,lo,hi", _MXU_PLANE_CASES)
def test_mxu_stream_plane_forms_hold_their_plain_versions(mxu_libs, name, shape, lo, hi, unit, mi, bf16):
    """#7's contraction form over several blocks, tiles a side and uneven
    shells; the shell passes through bitwise."""
    dev = mxu_libs
    kern, names = MXU_KERNELS[name]
    lo, hi = Dim3(*lo), Dim3(*hi)
    gs = (30, 80, 140)
    raws = [_mxu_data(shape, 150 + q, dev, bf16) for q in range(len(names))]
    org = torch.tensor([[0, 0, 0], [13, 17, 60], [5, 9, 3]][:shape[0]], dtype=torch.int32, device=dev)
    kw = dict(compute_unit=unit, mxu_input=mi)
    before = getattr(st.stream_plane_pass, _mxu_counter(mi))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = st.stream_plane_pass(kern, names, raws, lo, hi, 1, org, gs, **kw)
        torch.cuda.synchronize()
        want = st.stream_plane_pass_plain(kern, names, raws, lo, hi, 1, org, gs, **kw)
    assert getattr(st.stream_plane_pass, _mxu_counter(mi)) == before + 1
    X, Y, Z = shape[1:]
    inner = (slice(None), slice(lo.x, X - hi.x), slice(lo.y, Y - hi.y), slice(lo.z, Z - hi.z))
    for g, w in zip(got, want):
        _hold_axis(g[inner], w[inner], unit, mi, bf16, 1)
        g[inner] = w[inner]
        assert torch.equal(g, w)  # the shell passes through


@pytest.mark.parametrize("unit,mi,bf16", MXU_COMBOS)
@pytest.mark.parametrize("name", sorted(MXU_KERNELS))
@pytest.mark.parametrize("m,s", _MXU_WF_CASES)
@pytest.mark.parametrize("slabs", [False, True])
def test_mxu_stream_wavefront_forms_hold_their_plain_versions(mxu_libs, name, m, s, slabs, unit, mi, bf16):
    """#8's contraction form in the register-queue form (``m6``, ``one``) and
    the general form (``off``), plain and z-slab layouts, ragged blocks of
    several tiles and x chunks; compared on the valid region."""
    dev = mxu_libs
    kern, names = MXU_KERNELS[name]
    Xr, Yr, Zr = 90, 70, 130
    zv = 127 if slabs else Zr
    gs = _wavefront_gs(s, slabs)
    raws = [_mxu_data((2, Xr, Yr, Zr), 160 + q, dev, bf16) for q in range(len(names))]
    zs = [_mxu_data((2, Xr, 2 * s, Yr), 170 + q, dev, bf16) for q in range(len(names))] if slabs else None
    org = torch.tensor([[5, 0, 7], [gs[0] - 3, Yr - 2 * s, 0]], dtype=torch.int32, device=dev)
    kw = dict(z_slabs=zs, z_valid=zv if slabs else None, compute_unit=unit, mxu_input=mi)
    plan = st.stream_wavefront_launch(kern, names, raws, m, s, gs, z_slabs=zs, z_valid=kw["z_valid"],
                                      compute_unit=unit, mxu_input=mi)
    assert plan["form"] == ("general" if name == "off" else "queue")
    before = getattr(st.stream_wavefront_pass, _mxu_counter(mi))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got, got_z = st.stream_wavefront_pass(kern, names, raws, m, s, org, gs, **kw)
        torch.cuda.synchronize()
        want, want_z = st.stream_wavefront_pass_plain(kern, names, raws, m, s, org, gs, **kw)
    assert getattr(st.stream_wavefront_pass, _mxu_counter(mi)) == before + 1
    S = slice(s, -s)
    for g, w in zip(got, want):
        _hold_axis(g[:, S, S, s:zv - s], w[:, S, S, s:zv - s], unit, mi, bf16, m)
    for g, w in zip(got_z or [], want_z or []):
        _hold_axis(g[:, S, :, S], w[:, S, :, S], unit, mi, bf16, m)


@pytest.mark.parametrize("unit,mi,bf16", MXU_COMBOS)
@pytest.mark.parametrize("late", [False, True])
@pytest.mark.parametrize("m", range(1, 9))
def test_mxu_mean6_wavefront_forms_hold_their_plain_versions(mxu_libs, m, late, unit, mi, bf16):
    """#17's contraction form (the mean-of-6 form of the tensor-core builds),
    one march and two through the scratch, tiles and x chunks ending early
    or late."""
    from stencil_tpu_torch.ops import plane_stencil as ps

    shape = _mean6_shape(m, m, late)
    raw = _mxu_data(shape, 180 + m, mxu_libs, bf16)
    kw = dict(compute_unit=unit, mxu_input=mi, f32_accumulate=bf16)
    before = getattr(ps.mean6_shell_wavefront_step, _mxu_counter(mi))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = ps.mean6_shell_wavefront_step(raw, m, m, **kw)
        torch.cuda.synchronize()
        want = ps.mean6_shell_wavefront_step_plain(raw, m, m, **kw)
    assert getattr(ps.mean6_shell_wavefront_step, _mxu_counter(mi)) == before + 1
    S = slice(m, -m)
    _hold_axis(got[S, S, S], want[S, S, S], unit, mi, bf16, m)
    plan = ps.mean6_wavefront_launch(shape, m, m, "bf16" if bf16 else "native", unit, mi)
    assert plan["launches"] == jk.wavefront_marches(m) and plan["compute_unit"] == unit


@pytest.mark.parametrize("unit,mi,bf16", MXU_COMBOS)
@pytest.mark.parametrize("lo,hi", [((1, 1, 1), (1, 1, 1)), ((1, 2, 3), (3, 1, 2)), ((3, 3, 3), (3, 3, 3))])
def test_mxu_mean6_plane_forms_hold_their_plain_versions(mxu_libs, lo, hi, unit, mi, bf16):
    """#18's contraction entries, on a ragged block; the shell bitwise."""
    from stencil_tpu_torch.ops import plane_stencil as ps

    block = _mxu_data((37, 41, 70), 190, mxu_libs, bf16)
    kw = dict(compute_unit=unit, mxu_input=mi, f32_accumulate=bf16)
    before = getattr(ps.mean6_plane_step, _mxu_counter(mi))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = ps.mean6_plane_step(block, lo, hi, **kw)
        torch.cuda.synchronize()
        want = ps.mean6_plane_step_plain(block, lo, hi, **kw)
    assert getattr(ps.mean6_plane_step, _mxu_counter(mi)) == before + 1
    win = tuple(slice(lo[a], block.shape[a] - hi[a]) for a in range(3))
    _hold_axis(got[win], want[win], unit, mi, bf16, 1)
    got[win] = want[win]
    assert torch.equal(got, want)


@pytest.mark.parametrize("unit,mi,bf16", [("mxu", "f32", False), ("mxu_band", "bf16", False), ("mxu", "f32", True)])
def test_mxu_forms_at_the_main_path_shapes(mxu_libs, unit, mi, bf16):
    """The calls Astaroth's routes make at 8 fields x 512^3, one field each:
    the wrap pass over 512^3 at k = 16, the plane pass over (8, 262^3), the
    wavefront over 518^3 at m = 3; and the mean-of-6 kernels at 518^3."""
    from stencil_tpu_torch.ops import plane_stencil as ps

    torch.backends.cuda.matmul.allow_tf32 = False
    kern, names = AstarothSim._kernel_mxu, ["d0"]
    kw = dict(compute_unit=unit, mxu_input=mi)
    gs = (512, 512, 512)
    block = _mxu_data(gs, 200, mxu_libs, bf16)
    org = torch.zeros(3, dtype=torch.int32, device=mxu_libs)
    _hold_axis(st.stream_wrap_pass(kern, names, [block], 16, org, gs, **kw)[0],
               st.stream_wrap_pass_plain(kern, names, [block], 16, org, gs, **kw)[0], unit, mi, bf16, 16)
    del block
    s3 = Dim3(3, 3, 3)
    raws = [_mxu_data((8, 262, 262, 262), 201, mxu_libs, bf16)]
    org8 = torch.tensor([[x, y, z] for x in (0, 256) for y in (0, 256) for z in (0, 256)], dtype=torch.int32,
                        device=mxu_libs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = st.stream_plane_pass(kern, names, raws, s3, s3, 1, org8, gs, **kw)[0]
        want = st.stream_plane_pass_plain(kern, names, raws, s3, s3, 1, org8, gs, **kw)[0]
    S = slice(3, -3)
    _hold_axis(got[:, S, S, S], want[:, S, S, S], unit, mi, bf16, 1)
    del raws, got, want
    raw = _mxu_data((518, 518, 518), 202, mxu_libs, bf16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = st.stream_wavefront_pass(kern, names, [raw], 3, 3, org, gs, **kw)[0][0]
        want = st.stream_wavefront_pass_plain(kern, names, [raw], 3, 3, org, gs, **kw)[0][0]
        _hold_axis(got[S, S, S], want[S, S, S], unit, mi, bf16, 3)
        kw6 = dict(kw, f32_accumulate=bf16)
        got = ps.mean6_shell_wavefront_step(raw, 3, 3, **kw6)
        want = ps.mean6_shell_wavefront_step_plain(raw, 3, 3, **kw6)
        _hold_axis(got[S, S, S], want[S, S, S], unit, mi, bf16, 3)
        got = ps.mean6_plane_step(raw, s3, s3, **kw6)
        want = ps.mean6_plane_step_plain(raw, s3, s3, **kw6)
    _hold_axis(got[S, S, S], want[S, S, S], unit, mi, bf16, 1)


@pytest.mark.parametrize("unit,mi,bf16", [("mxu", "f32", False), ("mxu_band", "bf16", False), ("mxu", "bf16", True)])
@pytest.mark.parametrize("schedule,grid", [("auto", False), ("wavefront", False), ("wavefront", True),
                                           ("per-step", True)])
def test_astaroth_mxu_routes_on_card(dev, schedule, grid, unit, mi, bf16):
    """``AstarothSim(compute_unit=...)`` on each route against its vpu run at
    the same storage: the reassociation bound of ``tests/test_kernel_axes.py``'s
    ``test_stream_mxu_matches_vpu`` (4 roundings a level at the six-sum's
    magnitude; with bf16 operands tests/ulp.py's bf16-input bound on top, and
    a bf16 ulp a pass under bf16 storage); the launches in the form's
    counter, none in the vpu ones."""
    from stencil_tpu_torch.kernels import ledger

    steps, runs, counts = 6, [], None
    for u in ("vpu", unit):
        m = AstarothSim(64, 64, 64, num_quantities=2, kernel_impl="cuda", schedule=schedule, compute_unit=u,
                        mxu_input=mi if u != "vpu" else "auto", storage_dtype="bf16" if bf16 else None,
                        subdomains=8 if grid else 1)
        m.realize()
        ledger.reset_launch_counts()
        m.step(steps)
        counts = {k: v for k, v in ledger.launch_counts().items() if v}
        runs.append(np.stack([m.field(q) for q in range(2)]).astype(np.float64))
    route = m._step._stream_plan["route"]
    kernel = {"wrap": "stream_wrap_pass", "plane": "stream_plane_pass", "wavefront": "stream_wavefront_pass"}[route]
    assert counts.get(f"{kernel}_{_mxu_counter(mi)[:-9]}", 0) > 0 and kernel not in counts, counts
    top = float(np.abs(runs[0]).max())
    bound = 4 * steps * 6.0 * top * 2.0 ** -24  # 4 reordered roundings a level at the six-sum's magnitude
    bound += steps * 4 * 2.0 ** -9 * top if mi == "bf16" else 0.0  # a bf16 rounding an operand read
    bound += steps * 2.0 ** -7 * top if bf16 else 0.0  # a bf16 storage ulp a pass
    assert np.isfinite(runs[1]).all() and np.abs(runs[1] - runs[0]).max() <= bound


# --- the contraction under the fused halo and the split schedule (rows 7 and 8) --------


@pytest.fixture(scope="module")
def mxu_fused_libs():
    """The card, with the fused contraction libraries of ``MXU_KERNELS``
    (the plane's and every depth of the wavefront's), each operand type and
    storage, built up front, one nvcc each, all at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from stencil_tpu_torch.kernels import build

    want = []
    for name in MXU_KERNELS:
        for mi in ("f32", "bf16"):
            for bf16 in (False, True):
                sk = _mxu_sk(name, (18, 20, 70), mi, bf16)
                want.append(("stream_plane_fused", st._source(sk, "stream_plane_fused", [1], st._FUSED)))
                want += [("stream_wavefront_fused", st._source(sk, *st._wavefront_variant(m, True)))
                         for m in (1, 2, 3)]
    build.build_generated(dict.fromkeys(want))
    return torch.device("cuda")


def _mxu_fused_bufs(n, X, Y, Z, lo, hi, nf, seed, dev, bf16):
    return tuple([t.to(torch.bfloat16 if bf16 else torch.float32) for t in b]
                 for b in _fused_bufs(n, X, Y, Z, lo, hi, nf, seed, dev))


def _fused_counters(wrapper):
    return {c: getattr(wrapper, c) for c in ("launches", "fused_launches", "mxu_launches", "mxu_bf16in_launches",
                                             "fused_mxu_launches", "fused_mxu_bf16in_launches")}


@pytest.mark.parametrize("unit,mi,bf16", MXU_COMBOS)
@pytest.mark.parametrize("name", sorted(MXU_KERNELS))
@pytest.mark.parametrize("shape,lo,hi", _MXU_PLANE_CASES + [((2, 9, 40, 70), (1, 2, 1), (2, 1, 2))])
def test_mxu_stream_plane_fused_forms_hold_their_plain_versions(mxu_fused_libs, name, shape, lo, hi, unit, mi,
                                                                bf16):
    """#7's fused form under the contraction (one launch: the tile staged
    through the shell buffers) on ragged blocks with a stale shell and
    random buffers: the interior within 4 ulps a level (f32 operands),
    tests/ulp.py's bf16-input bound or a bf16 ulp; the shell, passed
    through from the buffers, bitwise; only the fused contraction counter
    moves."""
    dev = mxu_fused_libs
    kern, names = MXU_KERNELS[name]
    lo, hi = Dim3(*lo), Dim3(*hi)
    n, X, Y, Z = shape
    gs = (30, 80, 140)
    raws = [_mxu_data(shape, 250 + q, dev, bf16) for q in range(len(names))]
    fs = _mxu_fused_bufs(n, X, Y, Z, lo, hi, len(names), 260, dev, bf16)
    org = torch.tensor([[0, 0, 0], [13, 17, 60], [5, 9, 3]][:n], dtype=torch.int32, device=dev)
    kw = dict(compute_unit=unit, mxu_input=mi, fused_shell=fs)
    before = _fused_counters(st.stream_plane_pass)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # a band on an untilable plane names the dense form
        got = st.stream_plane_pass(kern, names, raws, lo, hi, 1, org, gs, **kw)
        torch.cuda.synchronize()
        want = st.stream_plane_pass_plain(kern, names, raws, lo, hi, 1, org, gs, **kw)
    form = "fused_" + _mxu_counter(mi)
    assert _fused_counters(st.stream_plane_pass) == dict(before, **{form: before[form] + 1})
    inner = (slice(None), slice(lo.x, X - hi.x), slice(lo.y, Y - hi.y), slice(lo.z, Z - hi.z))
    for g, w in zip(got, want):
        _hold_axis(g[inner], w[inner], unit, mi, bf16, 1)
        g[inner] = w[inner]
        assert torch.equal(g, w)  # the shell passes through from the buffers


@pytest.mark.parametrize("unit,mi,bf16", MXU_COMBOS)
@pytest.mark.parametrize("name", sorted(MXU_KERNELS))
@pytest.mark.parametrize("m,s", _MXU_WF_CASES)
def test_mxu_stream_wavefront_fused_forms_hold_their_plain_versions(mxu_fused_libs, name, m, s, unit, mi, bf16):
    """#8's fused form under the contraction, the register-queue form
    (``m6``, ``one``) and the general form (``off``), two ragged blocks with
    several tiles a side and x chunks, a stale shell and random buffers:
    the valid region within the bounds above; only the fused contraction
    counter moves."""
    dev = mxu_fused_libs
    kern, names = MXU_KERNELS[name]
    n, Xr, Yr, Zr = 2, 61 + s, 100, 77
    s3 = Dim3(s, s, s)
    raws = [_mxu_data((n, Xr, Yr, Zr), 270 + q, dev, bf16) for q in range(len(names))]
    fs = _mxu_fused_bufs(n, Xr, Yr, Zr, s3, s3, len(names), 280, dev, bf16)
    org = torch.tensor([[_FUSED_GS[0] - 2, 7, 3], [4, 90, 40]], dtype=torch.int32, device=dev)
    kw = dict(compute_unit=unit, mxu_input=mi)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        plan = st.stream_wavefront_launch(kern, names, raws, m, s, _FUSED_GS, fused=True, **kw)
        assert plan["form"] == ("general" if name == "off" else "queue") and plan["tiles_y"] >= 2
        before = _fused_counters(st.stream_wavefront_pass)
        got, got_z = st.stream_wavefront_pass(kern, names, raws, m, s, org, _FUSED_GS, fused_shell=fs, **kw)
        torch.cuda.synchronize()
        want, _ = st.stream_wavefront_pass_plain(kern, names, raws, m, s, org, _FUSED_GS, fused_shell=fs, **kw)
    form = "fused_" + _mxu_counter(mi)
    assert got_z is None
    assert _fused_counters(st.stream_wavefront_pass) == dict(before, **{form: before[form] + 1})
    S = slice(s, -s)
    for g, w in zip(got, want):
        _hold_axis(g[:, S, S, S], w[:, S, S, S], unit, mi, bf16, m)


@pytest.mark.parametrize("unit,mi", [("mxu", "f32"), ("mxu_band", "bf16")])
def test_mxu_fused_forms_at_the_main_path_shapes(dev, unit, mi):
    """The fused calls Astaroth's 2x2x2 routes make at 512^3: #7 over 8
    fields x (8, 262^3) and #8 over one field at m = 3, with (8, 6, 262,
    262) buffers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kern, names = AstarothSim._kernel_mxu, [f"d{q}" for q in range(8)]
    s3, ext, gs = Dim3(3, 3, 3), 262, (512, 512, 512)
    org8 = torch.tensor([[x, y, z] for x in (0, 256) for y in (0, 256) for z in (0, 256)], dtype=torch.int32,
                        device=dev)
    raws = [_rand((8, ext, ext, ext), 290 + q, dev) for q in range(8)]
    fs = _fused_bufs(8, ext, ext, ext, s3, s3, 8, 300, dev)
    kw = dict(compute_unit=unit, mxu_input=mi)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = st.stream_plane_pass(kern, names, raws, s3, s3, 1, org8, gs, fused_shell=fs, **kw)
        want = st.stream_plane_pass_plain(kern, names, raws, s3, s3, 1, org8, gs, fused_shell=fs, **kw)
        for g, w in zip(got, want):
            _hold_axis(g, w, unit, mi, False, 1)
        del got, want
        f1 = tuple([b[0]] for b in fs)
        got = st.stream_wavefront_pass(kern, names[:1], raws[:1], 3, 3, org8, gs, fused_shell=f1, **kw)[0][0]
        want = st.stream_wavefront_pass_plain(kern, names[:1], raws[:1], 3, 3, org8, gs, fused_shell=f1,
                                              **kw)[0][0]
    S = slice(3, -3)
    _hold_axis(got[:, S, S, S], want[:, S, S, S], unit, mi, False, 3)


#: Astaroth's fused and split runs under a unit: key -> (schedule, exchange route, halo, overlap)
_AST_MXU_FS = {"per-step fused": ("per-step", "yzpack_pallas", "fused", "auto"),
               "auto fused": ("auto", "yzpack_pallas", "fused", "auto"),
               "auto split": ("auto", "direct", "auto", "split"),
               "per-step split": ("per-step", "direct", "auto", "split")}


@pytest.mark.parametrize("unit,mi,bf16", [("mxu", "f32", False), ("mxu_band", "bf16", False), ("mxu", "f32", True)])
@pytest.mark.parametrize("key", sorted(_AST_MXU_FS))
def test_astaroth_mxu_fused_and_split_on_card(dev, key, unit, mi, bf16):
    """``AstarothSim(compute_unit=..., stream_halo="fused" / stream_overlap=
    "split")`` on 2x2x2 against its vpu run of the same schedule and
    storage, within ``test_astaroth_mxu_routes_on_card``'s bound; the fused
    runs launch the fused contraction form alone, the split runs the
    array contraction form (interior and band passes)."""
    from stencil_tpu_torch.kernels import ledger

    schedule, route, halo, overlap = _AST_MXU_FS[key]
    steps, runs, counts = 6, [], None
    for u in ("vpu", unit):
        m = AstarothSim(64, 64, 64, num_quantities=2, kernel_impl="cuda", schedule=schedule, exchange_route=route,
                        stream_halo=halo, stream_overlap=overlap, compute_unit=u,
                        mxu_input=mi if u != "vpu" else "auto", storage_dtype="bf16" if bf16 else None,
                        subdomains=8)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            m.realize()
        plan = m._step._stream_plan
        assert (plan["halo"], plan["overlap"]) == (("fused", "off") if halo == "fused" else ("array", "split"))
        ledger.reset_launch_counts()
        m.step(steps)
        counts = {k: v for k, v in ledger.launch_counts().items() if v}
        runs.append(np.stack([m.field(q) for q in range(2)]).astype(np.float64))
    kernel = f"stream_{plan['route']}_pass"
    form = f"{kernel}{'_fused' if halo == 'fused' else ''}_{_mxu_counter(mi)[:-9]}"
    others = [k for k in counts if k.startswith(kernel) and k != form]
    assert counts.get(form, 0) > 0 and not others, counts
    top = float(np.abs(runs[0]).max())
    bound = 4 * steps * 6.0 * top * 2.0 ** -24
    bound += steps * 4 * 2.0 ** -9 * top if mi == "bf16" else 0.0
    bound += steps * 2.0 ** -7 * top if bf16 else 0.0
    assert np.isfinite(runs[1]).all() and np.abs(runs[1] - runs[0]).max() <= bound


# --- the dispatch boundary and checkpoints on the card ------------------------------------------


_NUMERICS_CASES = {
    "even f32": ((64, 64, 64), torch.float32, "native", ()),
    "ragged 63^3": ((63, 63, 63), torch.float32, "native", ()),
    "bf16 storage": ((64, 64, 64), torch.float32, "bf16", ()),
    "f64": ((64, 48, 64), torch.float64, "native", ()),
    "vector (3,)": ((32, 32, 32), torch.float32, "native", (3,)),
}


@pytest.mark.parametrize("bad", [False, True])
@pytest.mark.parametrize("case", sorted(_NUMERICS_CASES))
def test_numerics_on_card_equal_the_cpu(dev, case, bad):
    """The same field on a card domain and a CPU domain: min, max, absmax,
    the counts and the first non-finite coordinate exactly, mean and L2
    within rtol 1e-5 (f32 fields: the card sums at f32, the CPU at f64) or
    1e-12 (f64 fields)."""
    from stencil_tpu_torch.core.radius import Radius
    from stencil_tpu_torch.domain import DistributedDomain

    size, dtype, storage, comps = _NUMERICS_CASES[case]
    a = (np.random.default_rng(7).random(comps + size) * 4 - 1).astype(
        np.float64 if dtype == torch.float64 else np.float32)
    if bad:
        a[(Ellipsis, 40 % size[0], 3, 50 % size[2])] = np.nan
        a[(Ellipsis, 33 % size[0], 20, 7)] = np.inf
    stats = []
    for device in (dev, "cpu"):
        d = DistributedDomain(*size, device=device)
        d.set_radius(Radius.constant(1))
        d.set_partition(2, 2, 2)
        if storage != "native":
            d.set_storage(storage)
        h = d.add_data("q", dtype=dtype, components=comps)
        d.realize()
        d.set_quantity(h, a)
        d.get_curr(h)[..., 1, 1, 1, 0, 3, 3] = float("nan")  # a shell cell: never read
        (st_,) = d.numerics().snapshot().stats
        stats.append(st_)
    got, want = stats
    for key in ("min", "max", "absmax", "finite", "nonfinite", "first_nonfinite"):
        assert getattr(got, key) == getattr(want, key), key
    for key in ("mean", "l2"):
        assert getattr(got, key) == pytest.approx(getattr(want, key), rel=1e-12 if dtype == torch.float64 else 1e-5), key
    assert (got.nonfinite > 0) == bad


def test_sentinel_coordinate_on_card(dev):
    from stencil_tpu_torch.resilience.taxonomy import DivergenceError

    m = Jacobi3D(128, 128, 128, kernel_impl="cuda", check_divergence_every=4)
    m.dd.set_partition(2, 2, 2)
    m.realize()
    m.step(8)
    lo = m.dd.shell_radius().lo()
    m.dd.get_curr(m.h)[1, 0, 1, lo.x + 17, lo.y + 40, lo.z + 3] = float("nan")
    with pytest.raises(DivergenceError) as err:
        m.step(4)
    want = tuple(int(v) for v in np.argwhere(~np.isfinite(m.temperature()))[0])
    assert (err.value.quantity, err.value.coord, err.value.window) == ("temp", want, (8, 12))


def test_watchdog_abort_on_card(dev):
    """Abort mode around a dispatch of well over a second of device work:
    a classified StallError within the deadline + 0.25 s."""
    import time

    from stencil_tpu_torch.resilience.taxonomy import StallError
    from stencil_tpu_torch.resilience.watchdog import DispatchWatchdog

    m = Jacobi3D(512, 512, 512, kernel_impl="cuda")
    m.realize()
    m.step(8)
    torch.cuda.synchronize()
    wd = DispatchWatchdog(0.05, abort=True)
    m.dd.set_watchdog(wd)
    t0 = time.perf_counter()
    try:
        with pytest.raises(StallError):
            m.step(6000)
        assert time.perf_counter() - t0 < 0.05 + 0.25
    finally:
        wd.close()
        torch.cuda.synchronize()


@pytest.mark.parametrize("storage", ["native", "bf16"])
def test_checkpoint_round_trip_on_card(dev, tmp_path, storage):
    """A 2x2x2 card run saved at step 6, restored into a fresh card domain
    on one subdomain and into a CPU domain (the plain versions): both end
    bitwise equal to the uninterrupted run at step 12, and the digests of
    the card's save and the CPU's agree."""
    import json

    from stencil_tpu_torch.io import checkpoint as ck

    def model(part, device, path="auto"):
        m = Jacobi3D(64, 64, 64, kernel_impl="cuda", device=device, storage_dtype=storage, pallas_path=path)
        m.dd.set_partition(*part)
        m.realize()
        return m

    ref = model((2, 2, 2), dev)
    ref.step(6)
    ck.save_checkpoint(ref.dd, str(tmp_path / "c"), step=6)
    ref.step(6)
    for part, device in (((1, 1, 1), dev), ((2, 2, 2), "cpu")):
        m = model(part, device)
        assert ck.restore_checkpoint(m.dd, str(tmp_path / "c")) == 6
        m.step(6)
        np.testing.assert_array_equal(m.temperature(), ref.temperature())
    cpu = model((2, 2, 2), "cpu")
    ck.restore_checkpoint(cpu.dd, str(tmp_path / "c"))
    ck.save_checkpoint(cpu.dd, str(tmp_path / "d"), step=6)
    digests = [json.load(open(tmp_path / p / "MANIFEST.json"))["quantities"][0]["digest"] for p in ("c", "d")]
    assert digests[0] == digests[1]


# --- the degradation ladders, the raw checkpoint backend, the supervisor (PR 25) ---------


@pytest.mark.parametrize("storage", ["native", "bf16"])
def test_raw_checkpoint_round_trip_on_card(dev, tmp_path, storage):
    """A 2x2x2 card run saved raw at step 6: restored onto the same grid its
    stacks install whole (shells included), onto 1x1x1 and onto a CPU
    domain they re-scatter; every restored run ends bitwise at step 12, and
    the raw save's digests are the npz save's."""
    import json

    from stencil_tpu_torch.io import checkpoint as ck

    def model(part, device):
        m = Jacobi3D(64, 64, 64, kernel_impl="cuda", device=device, storage_dtype=storage)
        m.dd.set_partition(*part)
        m.realize()
        return m

    ref = model((2, 2, 2), dev)
    ref.step(6)
    ck.save_checkpoint(ref.dd, str(tmp_path / "r"), step=6, backend="raw")
    ck.save_checkpoint(ref.dd, str(tmp_path / "n"), step=6)
    saved = ref.dd.get_curr(ref.h).clone()
    ref.step(6)
    same = model((2, 2, 2), dev)
    assert ck.restore_checkpoint(same.dd, str(tmp_path / "r")) == 6
    assert torch.equal(same.dd.get_curr(same.h), saved)
    for m in (same, model((1, 1, 1), dev), model((2, 2, 2), "cpu")):
        if m is not same:
            ck.restore_checkpoint(m.dd, str(tmp_path / "r"))
        m.step(6)
        np.testing.assert_array_equal(m.temperature(), ref.temperature())
    digests = [json.load(open(tmp_path / p / "MANIFEST.json"))["quantities"][0]["digest"] for p in ("r", "n")]
    assert digests[0] == digests[1]


@pytest.mark.parametrize("plan,kw,want,lower", [
    ("execute:compile_reject:jacobi*1", dict(partition=(2, 2, 2), pallas_path="wavefront", temporal_k=4),
     ["wavefront[depth=4]"], {"depth": 3}),
    ("execute:vmem_oom:jacobi*2", dict(partition=(1, 1, 1), temporal_k=4, compute_unit="mxu_band"),
     ["wrap[k=4,mxu_band]", "wrap[k=4,mxu]"], {"compute_unit": None}),
    ("execute:vmem_oom:jacobi*1", dict(partition=(1, 1, 1), temporal_k=4, storage_dtype="bf16"), ["wrap[k=4,bf16]"],
     {"storage_dtype": None}),
])
def test_jacobi_ladder_on_card(dev, plan, kw, want, lower):
    """Each descent lands on a CUDA route (no rung runs a plain version on
    the card: the launch counters move) and the run matches the card run
    that starts on the lower rung, bitwise (the wavefront's at depth 3 over
    the same 4-wide shell)."""
    from stencil_tpu_torch.kernels import ledger
    from stencil_tpu_torch.resilience import inject

    kw = dict(kw)
    part = kw.pop("partition")

    def model(**over):
        m = Jacobi3D(64, 64, 64, kernel_impl="cuda", device=dev, **{**kw, **over})
        m.dd.set_partition(*part)
        m.realize()
        return m

    m = model()
    inject.set_plan(plan)
    try:
        ledger.reset_launch_counts()
        m.step(10)
    finally:
        inject.set_plan(None)
    assert [name for name, _ in m._ladder.descents] == want
    assert sum(ledger.launch_counts().values()) > 0
    depth = lower.pop("depth", None)
    ref = model(**lower)
    if depth is not None:
        ref._wavefront_depth = depth
        ref.rebuild_after_reshard()
    assert ref._rung_name() == m._rung_name()
    ref.step(10)
    np.testing.assert_array_equal(m.temperature(), ref.temperature())


def test_stream_and_exchange_ladders_on_card(dev):
    """The stream engine m = 3 to 2 and the exchange route yzpack_pallas to
    direct on the card, bitwise against the undisturbed runs."""
    from stencil_tpu_torch.resilience import inject

    def sim(plan=None, **kw):
        inject.set_plan(plan)
        try:
            a = AstarothSim(32, 32, 32, num_quantities=2, kernel_impl="cuda", device=dev, **kw)
            if kw.get("subdomains"):
                a.dd.set_partition(2, 2, 2)
            a.realize()
            a.step(6)
        finally:
            inject.set_plan(None)
        return a

    ref, got = sim(schedule="wavefront"), sim("execute:vmem_oom:stream:wavefront[m=3]", schedule="wavefront")
    assert ref._wavefront_m == 3 and got._wavefront_m == 2
    kw = dict(schedule="per-step", subdomains=8, exchange_route="yzpack_pallas")
    pref, pgot = sim(**kw), sim("compile:compile_reject:exchange:yzpack_pallas", **kw)
    assert pref.dd.exchange_route() == "yzpack_pallas" and pgot.dd.exchange_route() == "direct"
    for a, b in ((ref, got), (pref, pgot)):
        for i in range(2):
            np.testing.assert_array_equal(a.field(i), b.field(i))


def test_supervised_restart_and_sticky_error_on_card(dev, tmp_path):
    """A FATAL restarts from the ring and ends bitwise; a sticky wording is
    never restarted in-process."""
    from stencil_tpu_torch.resilience import inject
    from stencil_tpu_torch.resilience.supervisor import RunSupervisor, SupervisorConfig

    def model():
        m = Jacobi3D(64, 64, 64, kernel_impl="cuda", device=dev)
        m.dd.set_partition(2, 2, 2)
        m.realize()
        return m

    ref = model()
    ref.step(24)
    m = model()
    sup = RunSupervisor(m.dd, SupervisorConfig(dir=str(tmp_path / "a"), every_steps=8, backend="raw"), label="jacobi")
    inject.set_plan("dispatch:fatal:jacobi@3*1")
    try:
        out = sup.run(24, lambda n: m.step(n), chunk=4)
    finally:
        inject.set_plan(None)
    assert out.completed and out.restarts == 1
    np.testing.assert_array_equal(m.temperature(), ref.temperature())

    def poisoned(n):
        raise RuntimeError("CUDA kernel launch failed (700): an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        RunSupervisor(m.dd, SupervisorConfig(dir=str(tmp_path / "b"), max_restarts=3), label="jacobi").run(
            4, poisoned)


# --- the autotuner and the toolchain report (PR 26) --------------------------------------


def test_toolchain_names_the_card(dev):
    from stencil_tpu_torch.kernels import toolchain

    tools = toolchain()
    assert tools["device"] == torch.cuda.get_device_name(0)
    assert tools["card"] is not None and tools["card"].startswith(tools["device"])
    assert tools["power_limit"] and tools["nvcc"] and tools["cuda"] == torch.version.cuda


def test_tune_search_on_card_cold_then_warm(dev, tmp_path, monkeypatch):
    """A wrap search on the card, cold: every trial launches the kernel at
    whole calls of its depth and the winner is stored; warm: zero trials and
    no launch.  A model built after it runs the tuned depth, bitwise equal
    to the same depth given explicitly."""
    from stencil_tpu_torch import tune
    from stencil_tpu_torch.tune.runners import autotune_jacobi_wrap

    monkeypatch.setenv("STENCIL_TUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("STENCIL_TUNE", raising=False)
    tune.reset_memo()
    before = jk.jacobi_wrap_step.launches
    cold = autotune_jacobi_wrap(64, 64, 64, device=dev, reps=1, ks=[2, 4])
    assert cold.source == "search" and cold.trials >= 3 and cold.config is not None
    assert all(cold.inner % r.config["k"] == 0 for r in cold.results)
    assert all(r.seconds_per_iter > 0 for r in cold.results if not r.pruned)
    assert jk.jacobi_wrap_step.launches > before
    tune.reset_memo()
    launched = sum(getattr(jk.jacobi_wrap_step, c) for c in jk.CONTRACTION_COUNTERS)
    warm = autotune_jacobi_wrap(64, 64, 64, device=dev, reps=1, ks=[2, 4])
    assert warm.cache_hit and warm.trials == 0 and warm.config == cold.config
    assert sum(getattr(jk.jacobi_wrap_step, c) for c in jk.CONTRACTION_COUNTERS) == launched
    cfg = cold.config
    tuned = Jacobi3D(64, 64, 64, kernel_impl="cuda", device=dev)
    tuned.realize()
    assert (tuned._wrap_k, tuned._compute_unit) == (cfg["k"], cfg["compute_unit"])
    explicit = Jacobi3D(64, 64, 64, kernel_impl="cuda", device=dev, temporal_k=cfg["k"],
                        compute_unit=cfg["compute_unit"], mxu_input=cfg.get("mxu_input", "f32"),
                        storage_dtype=cfg["storage_dtype"])
    explicit.realize()
    tuned.step(40)
    explicit.step(40)
    assert np.array_equal(tuned.temperature(), explicit.temperature())


# --- the drivers' route functions and transfers ----------------------------------------


def _route_pair(route, dev, size=(64, 48, 40), radius=2, nq=2):
    """The same seeded 2x2x2 domain on the card and on the CPU."""
    from stencil_tpu_torch.core.radius import Radius
    from stencil_tpu_torch.domain import DistributedDomain

    out = []
    for d in (dev, "cpu"):
        dd = DistributedDomain(*size, device=d)
        dd.set_radius(Radius.constant(radius))
        dd.set_partition(2, 2, 2)
        dd.set_exchange_route(route)
        hs = [dd.add_data(f"q{i}") for i in range(nq)]
        dd.realize()
        rng = np.random.default_rng(28)
        for h in hs:
            dd.set_quantity(h, rng.standard_normal(size).astype(np.float32))
        out.append((dd, hs))
    return out


@pytest.mark.parametrize("axes", [(0,), (1,), (2,), (0, 1, 2)])
@pytest.mark.parametrize("route", ["direct", "zpack_xla", "zpack_pallas", "yzpack_xla", "yzpack_pallas"])
def test_route_fn_per_axis_on_card_equals_cpu(dev, route, axes):
    """``make_exchange_route_fn(route, axes)`` on the card (the blend and
    shell kernels) bitwise equal to the CPU's (their plain versions)."""
    (cd, ch), (pd, ph) = _route_pair(route, dev)
    before = pk.pack_zshell_pallas.launches + pk.pack_yshell_pallas.launches + hb.blend_slab.launches
    cd.make_exchange_route_fn(route, axes=axes)([cd.get_curr(h) for h in ch])
    pd.make_exchange_route_fn(route, axes=axes)([pd.get_curr(h) for h in ph])
    torch.cuda.synchronize()
    assert pk.pack_zshell_pallas.launches + pk.pack_yshell_pallas.launches + hb.blend_slab.launches > before
    for a, b in zip(ch, ph):
        np.testing.assert_array_equal(cd.raw_to_host(a), pd.raw_to_host(b))


def test_transfers_between_two_buffers_on_the_card(dev):
    """``[dev, dev]``: two buffers on one card; an edge and a matrix
    traversal (each pair on a stream of its own) move every byte."""
    from stencil_tpu_torch.bin import _common

    eps = [dev, dev]
    go, (a, b) = _common.make_edge_transfer(eps, 0, 1, 1 << 20)
    a.copy_(torch.arange(1 << 20, dtype=torch.float32, device=dev))
    go()
    torch.cuda.synchronize()
    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    comm = np.array([[0, 4 << 20], [3 << 20, 0]], dtype=np.int64)
    go, bufs = _common.make_matrix_transfer(eps, comm)
    for k, (src, _) in enumerate(bufs):
        src.copy_(torch.rand(src.numel(), device=dev) + k)
    go()
    torch.cuda.synchronize()
    assert [s.numel() for s, _ in bufs] == [1 << 20, 3 << 18]
    assert all(torch.equal(s, d) for s, d in bufs)
    assert _common.measure_edge(eps, 0, 1, 1 << 24, 3) > 0
    assert _common.measure_matrix_concurrent(eps, comm, 3) > 0
    # one endpoint: the card with itself, as measure_edge pairs it
    assert _common.measure_matrix_concurrent([dev], np.full((1, 1), 1 << 24), 3) > 0
    assert _common.endpoints("cuda") == [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
