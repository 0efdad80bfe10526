"""strong on PyTorch + CUDA: the exchange-only strong-scaling CSV and the
stream engine's overlap A/B.

Counterpart of ``stencil_tpu/bin/strong.py`` (reference bin/strong.cu): the
same as ``weak``, but the global size is NOT scaled by the subdomain count
(strong.cu:30-48; default 512³), only rounded to the grid.  The same CSV row,
named ``strong``.  ``--overlap`` runs weak's A/B at the fixed global size
(``bin/weak.py``).

    python -m stencil_tpu_torch.bin.strong 512 512 512 30 --partition 2,2,2
    python -m stencil_tpu_torch.bin.strong 512 512 512 --overlap --mesh 2,2,2
"""

from __future__ import annotations

import sys

from stencil_tpu_torch.bin import _common
from stencil_tpu_torch.bin.weak import build_parser, emit_overlap, refuse_unported, run, run_overlap
from stencil_tpu_torch.core.radius import Radius


def main(argv=None) -> int:
    args = build_parser("strong").parse_args(argv)
    args.trivial = args.naive
    refuse_unported(args)
    _common.telemetry_begin(args)
    _common.tune_begin(args)
    try:
        if args.overlap:
            emit_overlap(run_overlap(args, name="strong", weak_scale=False), args)
            _common.telemetry_end(args)
            return 0
        x, y, z = _common.fit_to_mesh(args.x, args.y, args.z, Radius.constant(3), _common.subdomain_count(args),
                                      args.partition)
        print(run(x, y, z, args.n_iters, args, name="strong"))
        _common.telemetry_end(args)
        return 0
    finally:
        _common.tune_end(args)


if __name__ == "__main__":
    sys.exit(main())
