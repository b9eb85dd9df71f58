"""The reference's CLI surface for the port's entry points (the
``add_reference_compat_args`` half of dynamic_tuning_tpu/cli.py).

The reference's launch scripts pass launcher and DDP flags to every entry
point; ``add_reference_compat_args`` accepts them so those scripts run
unchanged.  ``--model`` and ``--log_dir`` keep their meaning; the rest are
accepted and do nothing here.
"""

from __future__ import annotations

import argparse


def add_reference_compat_args(parser: argparse.ArgumentParser):
    """Accept the rest of the reference CLI surface (main_image.py:40-131,
    main_video.py:40-150, speed.py, main_vtab.py)."""
    g = parser.add_argument_group("reference compatibility")
    g.add_argument("--model", default="vit_base_patch16_224_in21k",
                   help="model name (the reference ships this family)")
    g.add_argument("--log_dir", default="",
                   help="TensorBoard event dir (default: output_dir)")
    g.add_argument("--start_epoch", default=0, type=int,
                   help="first epoch index when not resuming")
    g.add_argument("--cls_token", action="store_true", default=True,
                   help="satisfied: CLS pooling is the live mode")
    g.add_argument("--dist_eval", action="store_true",
                   help="accepted; no effect here")
    g.add_argument("--pin_mem", action="store_true", default=True,
                   help="accepted; no effect here")
    g.add_argument("--no_pin_mem", action="store_false", dest="pin_mem")
    g.add_argument("--device", default=None,
                   help="ignored: the port runs on the current CUDA device")
    g.add_argument("--world_size", default=None, type=int,
                   help="ignored (no launcher)")
    g.add_argument("--local_rank", default=None, type=int,
                   help="ignored (no launcher)")
    g.add_argument("--dist_on_itp", action="store_true",
                   help="ignored (no launcher)")
    g.add_argument("--dist_url", default=None, help="ignored (no launcher)")
    g.add_argument("--global_pool", action="store_true",
                   help="declared but never read by the reference; accepted")
    g.add_argument("--vpt", action="store_true",
                   help="declared but never read by the reference; accepted")
    g.add_argument("--vpt_num", default=1, type=int, help="see --vpt")
    return parser
