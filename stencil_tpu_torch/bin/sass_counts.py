"""SASS instruction counts of the port's kernel builds, per kernel.

    python -m stencil_tpu_torch.bin.sass_counts [--out FILE]
    PYTHONPATH=<other tree> python <this file> --out FILE   # that tree's builds

Builds the float32 libraries of the stream kernel templates (#6-#8,
``csrc/stream_*.cu``) for the traced kernels ``chip_smoke.py`` builds
(Astaroth's over 8 fields and one, the 27-point, coordinate-forced,
two-field mean-of-6 and off-centre two-field kernels), each template and
depth; Astaroth's bf16-storage and float64 builds (keys
``astaroth8/astaroth1 bf16|f64 ...``) and its contraction builds
(``_kernel_mxu`` on f32 and bf16 operands, f32 and bf16 storage: keys
``mxu8/mxu1 <operands>[ bf16] ...``), the fused ones where the tree has
the fused contraction forms; and every build of ``csrc/jacobi_wavefront.cu`` the tree has (#1-#5
and #17: the f32 vpu build and the ``VARIANTS`` of ``kernels/build.py``,
bf16 storage, float64 and the tensor-core builds) and
``csrc/plane_stencil.cu`` (#18).  It disassembles each with ``cuobjdump
-sass`` and counts the instruction lines of every ``Function :`` (the
anonymous namespace's hash taken out of the name, so that two trees' names
match).  It prints, and writes to ``--out``, one JSON object: ``{"card",
"counts": {library key: {function: instructions}}, "total",
"totals": {library key: instructions}}``, the key naming the kernel,
template and depth (or the plain source's build, as ``library_name``), not
the source's hash.  It calls only what the port has had since the fused
forms landed, so two trees compare like with like.  Needs nvcc and
``cuobjdump`` (``$CUDA_HOME/bin``), not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys


def _kernels():
    import torch

    from stencil_tpu_torch.models.astaroth import AstarothSim

    ast = AstarothSim(8, 8, 8, device="cpu")._kernel

    def k27(views, info):
        src, acc = views["u"], 0.0
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    acc = acc + src.sh(dx, dy, dz) / (2.0 ** (abs(dx) + abs(dy) + abs(dz)))
        return {"u": acc / 8.0}

    def forced(views, info):
        src = views["u"]
        cx, cy, cz = info.coords()
        g = info.global_size
        val = (src.sh(1, 0, 0) + src.sh(-1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, -1, 0)) / 4.0
        d2 = (cx - g.x // 2) ** 2 + (cy - g.y // 2) ** 2 + (cz - g.z // 2) ** 2
        return {"u": torch.where(d2 < 9, 1.0, val * info.level)}

    def xdiag(views, info):
        u, c = views["u"], views["c"]
        return {"u": (u.sh(1, 1, 0) + c.sh(-1, 0, 1) + u.sh(0, -1, -1)) / 3.0, "c": c.sh(-1, 0, 0) * 0.5 + u.center()}

    return {"astaroth8": (ast, [f"d{q}" for q in range(8)]), "astaroth1": (ast, ["d0"]), "k27": (k27, ["u"]),
            "forced": (forced, ["u"]), "mean6x2": (ast, ["a", "b"]), "xdiag": (xdiag, ["u", "c"])}


def count_sass(text: str) -> dict:
    """Instructions per function of ``cuobjdump -sass`` output."""
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_\w*?_cu_[0-9a-f]+", "_GLOBAL__N_", m.group(1))
            counts[cur] = 0
        elif cur is not None and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[cur] += 1
    return counts


def _axis_jobs(st, StreamKernel, gs) -> dict:
    """Astaroth's bf16-storage and float64 builds of every template and
    depth, and its contraction builds (the fused ones where the wrappers
    count a fused contraction form)."""
    import torch

    from stencil_tpu_torch.models.astaroth import AstarothSim

    names = [f"d{q}" for q in range(8)]
    fused_mxu = hasattr(st.stream_plane_pass, "fused_mxu_launches")
    jobs = {}

    def add(key, sk8, sk1, fused=True):
        jobs[f"{key[0]} stream_wrap"] = ("stream_wrap", st._source(sk8, "stream_wrap", st._WRAP_LEVELS))
        jobs[f"{key[0]} stream_plane"] = ("stream_plane", st._source(sk8, "stream_plane", [1]))
        if fused:
            jobs[f"{key[0]} stream_plane_fused"] = ("stream_plane_fused",
                                                    st._source(sk8, "stream_plane_fused", [1], st._FUSED))
        for m in (1, 2, 3):
            jobs[f"{key[1]} stream_wavefront m={m}"] = ("stream_wavefront", st._source(sk1, *st._wavefront_variant(m)))
            if fused:
                jobs[f"{key[1]} stream_wavefront_fused m={m}"] = (
                    "stream_wavefront_fused", st._source(sk1, *st._wavefront_variant(m, True)))

    for label, dt in (("bf16", torch.bfloat16), ("f64", torch.float64)):
        add((f"astaroth8 {label}", f"astaroth1 {label}"),
            StreamKernel(AstarothSim._kernel, names, 1, gs, dtypes=[dt] * 8),
            StreamKernel(AstarothSim._kernel, names[:1], 1, gs, dtypes=[dt]))
    for mi in ("f32", "bf16"):
        for label, dt in (("", torch.float32), (" bf16", torch.bfloat16)):
            kw = dict(compute_unit="mxu", mxu_input=mi)
            add((f"mxu8 {mi}{label}", f"mxu1 {mi}{label}"),
                StreamKernel(AstarothSim._kernel_mxu, names, 1, gs, dtypes=[dt] * 8, **kw),
                StreamKernel(AstarothSim._kernel_mxu, names[:1], 1, gs, dtypes=[dt], **kw), fused_mxu)
    return jobs


def main(argv=None) -> int:
    p = argparse.ArgumentParser("sass-counts")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from stencil_tpu_torch.kernels import build
    from stencil_tpu_torch.ops import stream as st
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    cuobjdump = shutil.which("cuobjdump", path=os.pathsep.join(
        [os.environ.get("PATH", ""), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")]))
    if cuobjdump is None:
        print("sass-counts: cuobjdump not found", file=sys.stderr)
        return 1
    gs = (30, 40, 140)
    jobs = {}
    for name, (fn, names) in _kernels().items():
        sk = StreamKernel(fn, names, 1, gs)
        jobs[f"{name} stream_wrap"] = ("stream_wrap", st._source(sk, "stream_wrap", st._WRAP_LEVELS))
        jobs[f"{name} stream_plane"] = ("stream_plane", st._source(sk, "stream_plane", [1]))
        jobs[f"{name} stream_plane_fused"] = ("stream_plane_fused",
                                              st._source(sk, "stream_plane_fused", [1], st._FUSED))
        for m in (1, 2, 3):
            if not st.stream_smem_fits(m, len(names)):
                continue
            jobs[f"{name} stream_wavefront m={m}"] = ("stream_wavefront", st._source(sk, *st._wavefront_variant(m)))
            jobs[f"{name} stream_wavefront_fused m={m}"] = ("stream_wavefront_fused",
                                                            st._source(sk, *st._wavefront_variant(m, True)))
    jobs.update(_axis_jobs(st, StreamKernel, gs))
    paths = dict(zip(jobs, build.build_generated(list(jobs.values()))))
    # the plain sources' builds of rows 1-5, 17 and 18 that this tree has
    plain = [name for name in build.SOURCES if name.startswith("jacobi_wavefront") or name == "plane_stencil"]
    paths.update(build.build(plain))
    counts = {}
    for key, path in paths.items():
        out = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True, check=True).stdout
        counts[key] = count_sass(out)
    card = ""
    if shutil.which("nvidia-smi"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    result = {"card": card, "counts": counts,
              "total": sum(sum(c.values()) for c in counts.values()),
              "totals": {key: sum(c.values()) for key, c in counts.items()}}
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
