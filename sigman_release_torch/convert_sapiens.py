"""Sapiens ViT weights -> a port state file (port of the repository's
``scripts/convert_sapiens.py``).

    python -m sigman_release_torch.convert_sapiens --ckpt sapiens_1b.pt2 \
        --out sapiens_1b.pt [--check]

Reads a torchscript file or a saved ``state_dict`` of an mmpretrain-style
VisionTransformer (``convert.load_sapiens_source``), maps it onto the
Sapiens-1B-geometry ``ViTFeatureEncoder`` (``convert.convert_sapiens``:
regex-lenient names under any prefix, ``qkv`` split, the class-token
position dropped) and reports what was converted, the unmatched source
keys, the missing parameters and the shape mismatches. ``--out`` writes the
converted tensors as a port state file (its ``encoder`` entry), which
``train_dit --sapiens_path`` and ``training.checkpoint.load_params_any``
read; ``--check`` writes nothing.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch
from torch import nn

from sigman_release_torch import convert
from sigman_release_torch.models.encoders import sapiens_1b_encoder
from sigman_release_torch.training import checkpoint


def main(argv=None, *, encoder: Optional[nn.Module] = None) -> dict:
    """``encoder``: the module to convert into (default Sapiens-1B
    geometry, built on the meta device). Returns ``convert_sapiens``'s
    stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)

    if encoder is None:
        with torch.device("meta"):
            encoder = sapiens_1b_encoder()
    converted, stats = convert.convert_sapiens(
        convert.load_sapiens_source(args.ckpt), encoder, verbose=True)
    if args.check or not args.out:
        return stats
    checkpoint.save_torch(args.out, {"encoder": converted})
    print(f"[sapiens] wrote {args.out}", flush=True)
    return stats


if __name__ == "__main__":
    main()
