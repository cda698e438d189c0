"""The user workflows of the repo's `examples/` scripts, on the port.

One module per script, each run as `python -m
pffdtd_tpu_torch.examples.<name>` with a `main(argv=None)`; the work sits
in plain functions that tests call at a small size:

- `setup_1e9`: a 32 x 25 x 20 m box voxelized at 1.049 Gvox and run on
  the card on the step, tb and x-slab routes;
- `build_material_library`: the CTK / Musikverein material files;
- `ctk_cart_rir`, `mv_fcc_rir`: a model to processed RIRs;
- `bench_mv`: the Musikverein benchmark line;
- `ctk_cart_viz`, `mv_fcc_viz`: slice-animation frames (and the
  voxelization drawing).

Each takes `--device` (the card by default) and raises without a card, as
`TorchEngine` does.  The scripts that read the reference's data folder
(`models/` and `materials/*.h5`; `data` in the working directory by
default, where build_material_library writes `materials/`) raise a
FileNotFoundError naming the path it lacks.  Where an original rotates
with "auto", so do these (the port's rule: `scene.orientation_scores`).
"""

from __future__ import annotations

from pathlib import Path

import torch

REF = "data"

CTK_MATS = {
    "AcousticPanel": "ctk_acoustic_panel.h5",
    "Altar": "ctk_altar.h5",
    "Carpet": "ctk_carpet.h5",
    "Ceiling": "ctk_ceiling.h5",
    "Glass": "ctk_window.h5",
    "PlushChair": "ctk_chair.h5",
    "Tile": "ctk_tile.h5",
    "Walls": "ctk_walls.h5",
}
MV_MATS = {
    "Floor": "mv_floor.h5",
    "Chairs": "mv_chairs.h5",
    "Plasterboard": "mv_plasterboard.h5",
    "Window": "mv_window.h5",
    "Wood": "mv_wood.h5",
}
CTK_MODEL = "models/CTK_Church/model_export.json"
MV_MODEL = "models/Musikverein_ConcertHall/model_export.json"


def check_device(device) -> torch.device:
    """The torch device; a `cuda` device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: torch.cuda.is_available() is "
                           "False; pass --device cpu to run the plain "
                           "PyTorch versions on the CPU")
    return dev


def model_inputs(ref, model):
    """(model JSON, materials folder) under the data folder `ref`; raises
    FileNotFoundError naming the first of them that is missing."""
    ref = Path(ref)
    paths = (ref / model, ref / "materials")
    for p in paths:
        if not p.exists():
            raise FileNotFoundError(f"{p}: the reference data folder {ref} "
                                    f"lacks it")
    return paths


def add_common_args(ap, out_default):
    """The positional data folder and sim folder of the scripts that read
    a model (the originals' argv[1] and argv[2]), and --device."""
    ap.add_argument("ref", nargs="?", default=REF,
                    help="the reference data folder (models/, materials/)")
    ap.add_argument("out", nargs="?", default=out_default,
                    help="the sim folder to write")
    add_device_arg(ap)


def add_device_arg(ap):
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
