"""Standing rules of the PyTorch port.

* the port and ``chip_smoke.py`` import neither jax nor the JAX package;
* the kernel ledger covers exactly the JAX package's TPU kernels, every one
  of them marked ported;
* nothing falls back to the CPU or to a plain version on its own;
* the driver prints the reference's CSV row.
"""

import ast
import os

import pytest
import torch

from stencil_tpu.analysis.registry import PALLAS_KERNELS
from stencil_tpu_torch.kernels import build, ledger

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "stencil_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 15 and os.path.exists(files[0])
    # the serving layer and its drivers are among the files checked
    rel = {os.path.relpath(f, PORT) for f in files}
    assert {os.path.join("serve", m + ".py") for m in ("__init__", "request", "queue", "tenant", "policy", "aot",
                                                      "pack", "server")} <= rel
    assert {os.path.join("analysis", "__init__.py"), os.path.join("analysis", "vmem.py"),
            os.path.join("bin", "stencil_serve.py"), os.path.join("bin", "run_soak.py"),
            os.path.join("bin", "bench_serve.py")} <= rel
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "stencil_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, f"the port must not import jax or the JAX package: {bad}"


def test_ledger_covers_every_tpu_kernel():
    want = {(f, fn) for f, fns in PALLAS_KERNELS.items() for fn in fns}
    assert set(ledger.PORTED_KERNELS) == want
    # every TPU kernel has its hand-written counterpart
    assert set(ledger.ported()) == want
    for (path, fn), entry in ledger.PORTED_KERNELS.items():
        # every entry points at the line that defines the TPU kernel
        rel, line = entry["replaces"].split(":")
        assert rel == path
        with open(os.path.join(REPO, path)) as f:
            assert f.readlines()[int(line) - 1].startswith(f"def {fn}("), entry
        assert entry["source"].startswith("stencil_tpu_torch/csrc/") and entry["source"].endswith(".cu")
        assert os.path.exists(os.path.join(REPO, entry["source"]))
        assert callable(ledger.resolve(entry["kernel"])) and callable(ledger.resolve(entry["plain"]))
    ledger.reset_launch_counts()
    counts = ledger.launch_counts()
    assert set(counts.values()) == {0}
    assert {"jacobi_slab_step", "blend_slab_dynamic", "pack_zshell_pallas", "unpack_yshell_pallas",
            "pallas_pack_slab", "pallas_unpack_slab", "mean6_shell_wavefront_step", "mean6_plane_step"} <= set(counts)


def test_ledger_lists_the_contraction_forms():
    """The tensor-core contraction forms of rows 6-8, 17 and 18 count apart,
    on f32 and bf16 operands, each under its wrapper's counter."""
    want = {f"{fn}_{form}" for fn in ("stream_wrap_pass", "stream_plane_pass", "stream_wavefront_pass",
                                      "mean6_shell_wavefront_step", "mean6_plane_step")
            for form in ("mxu", "mxu_bf16in")}
    assert want <= set(ledger.FORMS)
    for name in want:
        wrapper, attr = ledger.counter(name)
        assert attr == ("mxu_bf16in_launches" if name.endswith("bf16in") else "mxu_launches")
        assert getattr(wrapper, attr) == 0 or ledger.launch_counts()[name] == getattr(wrapper, attr)


def test_ledger_lists_the_fused_contraction_forms():
    """The fused forms of rows 7 and 8 under the contraction count apart,
    on f32 and bf16 operands, each under its wrapper's fused counter; they
    are the only fused contraction forms."""
    want = {f"stream_{fn}_pass_fused_{form}" for fn in ("plane", "wavefront") for form in ("mxu", "mxu_bf16in")}
    assert {name for name in ledger.FORMS if "_fused_mxu" in name} == want
    for name in want:
        wrapper, attr = ledger.counter(name)
        assert wrapper.__name__ == name.split("_fused")[0]
        assert attr == ("fused_mxu_bf16in_launches" if name.endswith("bf16in") else "fused_mxu_launches")
    ledger.reset_launch_counts()
    assert all(ledger.launch_counts()[name] == 0 for name in want)


def test_default_device_without_gpu_raises(monkeypatch):
    from stencil_tpu_torch.domain import DistributedDomain
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Jacobi3D(8, 8, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedDomain(8, 8, 8)
    Jacobi3D(8, 8, 8, device="cpu")  # an explicit CPU request is honoured


def test_missing_nvcc_raises_and_hands_back_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda *a, **k: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(build.KernelBuildError, match="nvcc was not found"):
        build.build()
    with pytest.raises(build.KernelBuildError, match="nvcc was not found"):
        build.load("jacobi_wavefront")
    assert os.listdir(tmp_path) == []


def test_failed_compile_raises_with_compiler_output(monkeypatch, tmp_path):
    """A build whose compiler fails raises with the compiler's own output."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: this compiler refuses' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build.shutil, "which", lambda *a, **k: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(build.KernelBuildError, match="this compiler refuses"):
        build.build(["plane_stencil"])


def test_driver_prints_csv_row(capsys):
    from stencil_tpu_torch.bin import jacobi3d

    rc = jacobi3d.main(["8", "8", "8", "--iters", "3", "--device", "cpu", "--partition", "2,2,2"])
    assert rc == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert row[:4] == ["jacobi3d", "ppermute", "1", "1"]
    # weak-scaled by numSubdoms^(1/3): 8 * 8^(1/3) rounds to 16
    assert row[4:7] == ["16", "16", "16"]
    assert float(row[7]) > 0 and float(row[8]) >= float(row[7])
    rc = jacobi3d.main(
        ["8", "8", "8", "--no-weak-scale", "--iters", "2", "--device", "cpu",
         "--kernel-impl", "torch", "--peer", "--kernel"]
    )
    assert capsys.readouterr().out.strip().split(",")[:7] == [
        "jacobi3d", "peer/kernel", "1", "1", "8", "8", "8"
    ]
