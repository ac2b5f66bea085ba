"""CLI: live training dashboard over metrics.jsonl logs.

The PyTorch package's copy of :mod:`geomapnet_tpu.cli.dashboard`. Replaces
upstream's visdom server+client pair (upstream common/train.py:120-141;
``--log_visdom`` in its configs):
same three windows (train/val loss, log10(lr), criterion parameters) plus
step timing, rendered from the Trainer's metrics.jsonl stream — live during
training or post-hoc on finished runs.

    python -m geomapnet_tpu_torch.cli.dashboard --logdir logs --port 8097
"""

from __future__ import annotations

import argparse

from ..utils.dashboard import serve_forever


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--logdir", default="logs",
                    help="experiment dir or a root containing many")
    ap.add_argument("--port", type=int, default=8097,
                    help="visdom's default; 0 picks an ephemeral port")
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args(argv)
    serve_forever(args.logdir, args.port, args.host)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
