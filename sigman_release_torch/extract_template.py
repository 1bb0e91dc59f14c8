"""One-time template extraction (port of the repository's
``scripts/extract_template.py``).

    python -m sigman_release_torch.extract_template \
        --smplx ./assets/SMPLX_NEUTRAL.npz --out ./assets/template \
        [--seg ./assets/smplx_vert_segmentation.json] [--device cpu]

Subdivides the ``SUBDIVIDE_REGIONS`` found in the segmentation JSON (region
name -> vertex ids) once and writes the reference's ``init_*_smplx_thu.npy``
set that ``--template_dir`` reads. Without ``--smplx`` the procedural body
model is used. ``--device`` defaults to ``cuda`` and raises without it.
"""

from __future__ import annotations

import argparse
import json

from sigman_release_torch.body.smplx import load_smplx_npz, synthetic_body_model
from sigman_release_torch.body.subdivide import bake_template, save_template_dir
from sigman_release_torch.body.template import TemplateAssets
from sigman_release_torch.device import resolve_device

SUBDIVIDE_REGIONS = [
    "head", "leftEye", "rightEye", "leftEar", "rightEar",
    "leftHand", "rightHand", "leftHandIndex1", "rightHandIndex1",
]


def main(argv=None) -> TemplateAssets:
    """Returns the baked template (on the device)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--smplx", default=None,
                    help="SMPLX_*.npz model (synthetic body if omitted)")
    ap.add_argument("--seg", default=None,
                    help="vertex segmentation json (region -> vertex ids)")
    ap.add_argument("--out", default="./assets/template")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model = (load_smplx_npz(args.smplx, device=dev) if args.smplx
             else synthetic_body_model(device=dev))
    regions = None
    if args.seg:
        with open(args.seg) as f:
            seg = json.load(f)
        regions = [seg[name] for name in SUBDIVIDE_REGIONS if name in seg]

    template = bake_template(model, subdivide_regions=regions)
    save_template_dir(template, args.out)
    print(f"baked {template.num_gaussians} gaussian anchors -> {args.out}",
          flush=True)
    return template


if __name__ == "__main__":
    main()
