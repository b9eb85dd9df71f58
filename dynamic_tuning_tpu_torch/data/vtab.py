"""VTAB-1K registry: 19 tasks + class counts (reference datasets/vtab.py:8-30)
and the train800val200/test filelist convention (:54-74); a copy of
dynamic_tuning_tpu/data/vtab.py."""

from __future__ import annotations

VTAB_TASKS = {
    "cifar_vtab": 100,
    "caltech101": 102,
    "dtd_vtab": 47,
    "oxford_flowers102": 102,
    "oxford_iiit_pet_vtab": 37,
    "svhn_vtab": 10,
    "sun397": 397,
    "patch_camelyon": 2,
    "eurosat": 10,
    "resisc45": 45,
    "diabetic_retinopathy": 5,
    "clevr_count": 8,
    "clevr_dist": 6,
    "dmlab": 6,
    "kitti": 4,
    "dsprites_loc": 16,
    "dsprites_ori": 16,
    "smallnorb_azi": 18,
    "smallnorb_ele": 9,
}

# names as they appear in the upstream VTAB folder layout
ALIASES = {
    "cifar": "cifar_vtab",
    "dtd": "dtd_vtab",
    "oxford_iiit_pet": "oxford_iiit_pet_vtab",
    "svhn": "svhn_vtab",
}


def vtab_num_classes(task: str) -> int:
    task = ALIASES.get(task, task)
    if task not in VTAB_TASKS:
        raise KeyError(f"unknown VTAB task {task}; know {sorted(VTAB_TASKS)}")
    return VTAB_TASKS[task]


def parse_filelist(path: str):
    """Parse a `relative/img/path label` list file (train800val200.txt /
    test.txt)."""
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rel, lab = line.rsplit(" ", 1)
            items.append((rel, int(lab)))
    return items
