"""Reference safetensors -> a port state file (port of the repository's
``scripts/convert_reference_ckpt.py``).

    python -m sigman_release_torch.convert_reference_ckpt \
        --ckpt autoencoder.safetensors --out vae_params.pt [--check]

``--model`` (``dit``, ``vae`` or ``disc``) is inferred from the names when
left out (``autoencoder.`` a VAE, ``main.`` a discriminator, else a DiT);
``--preset`` gives the model's geometry (default ``dit`` for a DiT, else
``vae_b``). The file's tensors are renamed by ``convert.from_reference``
and checked against the module's parameters (built on the meta device:
names and shapes only); the report lists the file's unmapped names, the
module's missing parameters and shape mismatches. ``--out`` writes the
matching tensors as a port state file (the ``vae`` / ``model`` / ``disc``
entry) that ``training.checkpoint.load_params_any`` reads; ``--check``
writes nothing.
"""

from __future__ import annotations

import argparse

import torch

from sigman_release_torch import convert
from sigman_release_torch.config import PRESETS
from sigman_release_torch.losses.gan import PatchDiscriminator, disc_layers
from sigman_release_torch.models.dit import DiTModel
from sigman_release_torch.models.vae import VAEModel
from sigman_release_torch.training import checkpoint


def build_meta(kind: str, cfg) -> torch.nn.Module:
    """The ``kind`` model of ``cfg`` on the meta device."""
    with torch.device("meta"):
        if kind == "vae":
            return VAEModel(cfg)
        if kind == "disc":
            return PatchDiscriminator(n_layers=disc_layers(cfg.output_size))
        return DiTModel(cfg)


def coverage(converted, module, unmapped) -> dict:
    """{"converted", "missing", "mismatches", "unmapped"} of a conversion
    into ``module``; printed as the JAX package's converter prints it."""
    target = module.state_dict()
    missing = sorted(k for k in target if k not in converted)
    mismatches = [f"{k}: {tuple(v.shape)} vs {tuple(target[k].shape)}"
                  for k, v in converted.items()
                  if k in target and tuple(v.shape) != tuple(target[k].shape)]
    hits = len(converted) - len(mismatches)
    print(f"[convert] {hits} converted, {len(missing)} missing, "
          f"{len(mismatches)} shape mismatches, {len(unmapped)} unmapped "
          f"source keys", flush=True)
    for s in missing[:20]:
        print("  missing:", s)
    for s in mismatches[:20]:
        print("  mismatch:", s)
    for s in unmapped[:40]:
        print("  unmapped (DROPPED):", s)
    return {"converted": hits, "missing": missing, "mismatches": mismatches,
            "unmapped": unmapped}


def main(argv=None) -> dict:
    """Returns the coverage report (``coverage``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="reference safetensors file")
    ap.add_argument("--model", default=None, choices=("dit", "vae", "disc"),
                    help="checkpoint family; inferred from keys if omitted")
    ap.add_argument("--preset", default=None)
    ap.add_argument("--out", default=None, help="port state file to write")
    ap.add_argument("--check", action="store_true",
                    help="report mapping coverage only")
    args = ap.parse_args(argv)

    sd = checkpoint.read_safetensors(args.ckpt)
    kind = args.model or convert.reference_family(sd)
    cfg = PRESETS[args.preset or ("dit" if kind == "dit" else "vae_b")]
    module = build_meta(kind, cfg)
    converted, unmapped = convert.from_reference(sd, module)
    report = coverage(converted, module, unmapped)
    if args.check or not args.out:
        return report
    target = module.state_dict()
    weights = {k: v for k, v in converted.items()
               if k in target and tuple(v.shape) == tuple(target[k].shape)}
    entry = dict(checkpoint.PORT_ENTRIES)[type(module).__name__]
    checkpoint.save_torch(args.out, {entry: weights})
    print(f"[convert] wrote {args.out}", flush=True)
    return report


if __name__ == "__main__":
    main()
