"""The message layout, the slab packs and bench-pack of the port against the
JAX package's ``stencil_tpu/ops/pack.py`` and ``bin/bench_pack.py``.

* ``next_align_of`` and ``PackPlan`` field by field against the JAX plan,
  including the reference's 264-byte multi-dtype case;
* ``make_pack_fn``'s uint8 buffer byte for byte against the JAX buffer, and
  ``make_unpack_fn``'s blocks against the JAX unpack's;
* ``pallas_pack_slab`` / ``pallas_unpack_slab`` (on CPU tensors, the plain
  versions) against the Pallas kernels in interpret mode on faces, an edge
  and a corner, the cells outside the box untouched;
* bench-pack's output schema (``tests/test_drivers.py``'s oracle).

Every comparison is bitwise.  tests/conftest.py sets ``JAX_ENABLE_X64=1``, so
the JAX side gets explicit f32, uint8 and f64 arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.core.geometry import LocalSpec as JLocalSpec
from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.ops import pack as jpk
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.geometry import LocalSpec
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.ops import pack as pk

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64), "u8": (np.uint8, torch.uint8)}


def _specs(size, radius):
    """The same LocalSpec in both packages; ``radius`` maps a Radius class
    to a radius."""
    return (LocalSpec.make(Dim3.of(size), Dim3(0, 0, 0), radius(Radius)),
            JLocalSpec.make(JDim3.of(size), JDim3(0, 0, 0), radius(JRadius)))


def _multi_radius(R):
    # test_cuda_packer.cu:51-60: +x radius 2, -x radius 1
    r = R.constant(0)
    r.set_dir((1, 0, 0), 2)
    r.set_dir((-1, 0, 0), 1)
    return r


def _assert_plans_equal(plan, jplan):
    assert plan.size == jplan.size
    assert len(plan.slots) == len(jplan.slots)
    for s, j in zip(plan.slots, jplan.slots):
        assert (tuple(s.direction), s.quantity, s.offset, tuple(s.pos), tuple(s.unpack_pos), tuple(s.extent),
                s.itemsize, s.nbytes) == (tuple(j.direction), j.quantity, j.offset, tuple(j.pos),
                                          tuple(j.unpack_pos), tuple(j.extent), j.itemsize, j.nbytes)


def _seeded(shape, np_dtype, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(np_dtype).kind == "f":
        return rng.standard_normal(shape).astype(np_dtype)
    return rng.integers(0, 256, size=shape).astype(np_dtype)


def test_next_align_of():
    # reference test_cuda_align.cu:5-16, the cases of tests/test_pack.py
    for x, align, want in ((0, 4, 0), (1, 4, 4), (4, 4, 4), (5, 8, 8), (80, 8, 80)):
        assert pk.next_align_of(x, align) == jpk.next_align_of(x, align) == want


def test_plan_264_bytes():
    """+x message, quantities f32/char/f64: 80 + 20 -> align 104 + 160 = 264."""
    spec, jspec = _specs((3, 4, 5), _multi_radius)
    plan = pk.PackPlan.make(spec, [Dim3(1, 0, 0)], [4, 1, 8])
    assert plan.size == 264
    assert [s.offset for s in plan.slots] == [0, 80, 104]
    assert all(s.extent == Dim3(1, 4, 5) for s in plan.slots)
    _assert_plans_equal(plan, jpk.PackPlan.make(jspec, [JDim3(1, 0, 0)], [4, 1, 8]))


def test_plan_sorted_and_symmetric():
    spec, jspec = _specs((3, 4, 5), lambda R: R.constant(2))
    dirs = [(-1, -1, -1), (1, 1, 1), (0, 1, 1), (0, 0, 1)]
    plan = pk.PackPlan.make(spec, dirs, [4, 1, 8])
    assert [s.direction for s in plan.slots[::3]] == sorted(Dim3.of(d) for d in dirs)
    assert all(s.offset % s.itemsize == 0 for s in plan.slots)
    _assert_plans_equal(plan, jpk.PackPlan.make(jspec, [JDim3.of(d) for d in dirs], [4, 1, 8]))
    _assert_plans_equal(pk.PackPlan.make(spec, dirs[::-1], [4, 1, 8]), plan)


def test_plan_zero_size_raises():
    spec, jspec = _specs((3, 4, 5), lambda R: R.constant(0))
    with pytest.raises(ValueError, match="zero-size"):
        pk.PackPlan.make(spec, [Dim3(1, 0, 0)], [4])
    with pytest.raises(ValueError, match="zero-size"):
        jpk.PackPlan.make(jspec, [JDim3(1, 0, 0)], [4])


#: (size, radius, directions, dtypes): tests/test_pack.py's three direction
#: sets, and the multi-radius case with f32 / uint8 / f64
BUFFER_CASES = {
    "x": ((6, 5, 4), lambda R: R.constant(2), [(1, 0, 0)], ("f32", "f64")),
    "pm_x": ((6, 5, 4), lambda R: R.constant(2), [(-1, 0, 0), (1, 0, 0)], ("f32", "f64")),
    "mixed_dirs": ((6, 5, 4), lambda R: R.constant(2), [(0, 1, 0), (0, 0, -1), (1, 1, 1)], ("f32", "f64")),
    "multi_radius": ((3, 4, 5), _multi_radius, [(-1, 0, 0), (1, 0, 0)], ("f32", "u8", "f64")),
}


def _case_blocks(spec, dtypes, seed):
    raw = tuple(spec.raw_size())
    return [_seeded(raw, DTYPES[t][0], seed + i) for i, t in enumerate(dtypes)]


@pytest.mark.parametrize("case", sorted(BUFFER_CASES))
def test_pack_buffer_equals_jax(case):
    size, radius, dirs, dtypes = BUFFER_CASES[case]
    spec, jspec = _specs(size, radius)
    src = _case_blocks(spec, dtypes, 1)
    pack, plan = pk.make_pack_fn(spec, dirs, [DTYPES[t][1] for t in dtypes])
    jpack, jplan = jpk.make_pack_fn(jspec, [JDim3.of(d) for d in dirs], [DTYPES[t][0] for t in dtypes])
    _assert_plans_equal(plan, jplan)
    buf = pack([torch.from_numpy(b) for b in src])
    want = np.asarray(jpack([jnp.asarray(b) for b in src]))
    assert buf.dtype == torch.uint8 and tuple(buf.shape) == (plan.size,)
    np.testing.assert_array_equal(buf.numpy(), want)


@pytest.mark.parametrize("case", sorted(BUFFER_CASES))
def test_unpack_equals_jax(case):
    size, radius, dirs, dtypes = BUFFER_CASES[case]
    spec, jspec = _specs(size, radius)
    src, dst = _case_blocks(spec, dtypes, 1), _case_blocks(spec, dtypes, 11)
    tdt = [DTYPES[t][1] for t in dtypes]
    buf = pk.make_pack_fn(spec, dirs, tdt)[0]([torch.from_numpy(b) for b in src])
    unpack, _ = pk.make_unpack_fn(spec, dirs, tdt)
    got = unpack(buf, [torch.from_numpy(b.copy()) for b in dst])
    junpack, _ = jpk.make_unpack_fn(jspec, [JDim3.of(d) for d in dirs], [DTYPES[t][0] for t in dtypes])
    want = junpack(jnp.asarray(buf.numpy()), [jnp.asarray(b) for b in dst])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


#: faces of tests/test_pack.py:139, an edge and a corner
SLAB_DIRS = [(1, 0, 0), (0, -1, 0), (0, 0, 1), (1, 1, 0), (-1, 1, -1)]


@pytest.mark.parametrize("direction", SLAB_DIRS)
def test_slab_kernels_plain_equal_pallas_interpret(direction):
    spec, jspec = _specs((8, 8, 8), lambda R: R.constant(3))
    src, dst = _seeded(tuple(spec.raw_size()), np.float32, 5), _seeded(tuple(spec.raw_size()), np.float32, 6)
    jd = JDim3.of(direction)
    jpack, jplan = jpk.make_pack_fn_pallas(jspec, [jd], jnp.float32, interpret=True)
    junpack, _ = jpk.make_unpack_fn_pallas(jspec, [jd], jnp.float32, interpret=True)
    pack, plan = pk.make_pack_fn_pallas(spec, [direction], torch.float32)
    unpack, _ = pk.make_unpack_fn_pallas(spec, [direction], torch.float32)
    _assert_plans_equal(plan, jplan)

    before = (pk.pallas_pack_slab.launches, pk.pallas_unpack_slab.launches)
    slabs = pack(torch.from_numpy(src))
    jslabs = jpack(jnp.asarray(src))
    for s, j in zip(slabs, jslabs):
        np.testing.assert_array_equal(s.numpy(), np.asarray(j))
    got = unpack(torch.from_numpy(dst.copy()), slabs).numpy()
    np.testing.assert_array_equal(got, np.asarray(junpack(jnp.asarray(dst), jslabs)))
    # the CPU tensors ran the plain versions: no launch counted
    assert (pk.pallas_pack_slab.launches, pk.pallas_unpack_slab.launches) == before

    (slot,) = plan.slots
    u, e = slot.unpack_pos, slot.extent
    outside = np.ones(dst.shape, bool)
    outside[u.x:u.x + e.x, u.y:u.y + e.y, u.z:u.z + e.z] = False
    np.testing.assert_array_equal(got[outside], dst[outside])
    p = slot.pos
    np.testing.assert_array_equal(got[~outside].reshape(tuple(e)), src[p.x:p.x + e.x, p.y:p.y + e.y, p.z:p.z + e.z])


@pytest.mark.parametrize("dtype", [np.float64, np.int16, np.uint8])
def test_slab_kernels_plain_any_width_equal_pallas_interpret(dtype):
    """A ragged block and box of 8, 2 and 1-byte dtypes, by the functions
    themselves."""
    block = _seeded((9, 10, 11), dtype, 7)
    pos, ext = Dim3(2, 1, 3), Dim3(4, 7, 5)
    jpos, jext = JDim3(2, 1, 3), JDim3(4, 7, 5)
    slab = pk.pallas_pack_slab(torch.from_numpy(block), pos, ext)
    np.testing.assert_array_equal(slab.numpy(), np.asarray(jpk.pallas_pack_slab(jnp.asarray(block), jpos, jext,
                                                                                  interpret=True)))
    new = _seeded(tuple(ext), dtype, 8)
    got = pk.pallas_unpack_slab(torch.from_numpy(block.copy()), torch.from_numpy(new), pos, ext)
    want = jpk.pallas_unpack_slab(jnp.asarray(block), jnp.asarray(new), jpos, jext, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_slab_wrappers_refuse_what_the_kernels_do_not_take():
    block = torch.zeros(6, 6, 6)
    with pytest.raises(TypeError, match="1/2/4/8-byte"):
        pk.pallas_pack_slab(torch.zeros(6, 6, 6, dtype=torch.complex128), Dim3(0, 0, 0), Dim3(1, 1, 1))
    with pytest.raises(ValueError, match="leaves block"):
        pk.pallas_pack_slab(block, Dim3(4, 0, 0), Dim3(3, 1, 1))
    with pytest.raises(ValueError, match="slab shape"):
        pk.pallas_unpack_slab(block, torch.zeros(2, 2, 2), Dim3(0, 0, 0), Dim3(2, 2, 3))
    with pytest.raises(TypeError, match="slab dtype"):
        pk.pallas_unpack_slab(block, torch.zeros(2, 2, 2, dtype=torch.float64), Dim3(0, 0, 0), Dim3(2, 2, 2))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_bench_pack(capsys, backend):
    """tests/test_drivers.py's oracle: three lines, bytes column 12*12*3*4."""
    from stencil_tpu_torch.bin.bench_pack import main

    assert main(["--iters", "1", "--size", "12", "--backend", backend, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3  # x, y, z faces (bench_pack.cu:91-107)
    for line, face in zip(out, ("[1,0,0]", "[0,1,0]", "[0,0,1]")):
        cols = line.split()
        assert cols[:2] == ["[12,12,12]", face]
        assert int(cols[2]) == 12 * 12 * 3 * 4  # face slab bytes, r=3 f32
        assert float(cols[3]) > 0 and float(cols[4]) > 0
        assert cols[5].endswith("GB/s")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_bench_pack_roundtrip(capsys, backend):
    from stencil_tpu_torch.bin.bench_pack import main

    assert main(["--iters", "1", "--size", "12", "--backend", backend, "--device", "cpu", "--inner", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3
    for line in out:
        cols = line.split()
        assert int(cols[2]) == 12 * 12 * 3 * 4 and cols[3] == "roundtrip"
        assert float(cols[4]) > 0 and cols[5].endswith("GB/s")
