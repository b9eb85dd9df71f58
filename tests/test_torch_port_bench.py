"""The port's bench on the CPU: its line has the root bench's key set, and
it refuses to run without a card (a measurement never falls back to the
CPU)."""

import json
import os

import pytest

from dynamic_tuning_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fields_are_the_root_bench_line_keys():
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        want = list(json.load(f)["parsed"])
    assert list(bench.FIELDS) == want
    assert set(bench.NULL_BY_DESIGN) < set(bench.FIELDS)
    # the video fields are measured (video_family), not null by design
    video = {k for k in bench.FIELDS if k.startswith("video_")}
    assert len(video) == 5 and not video & set(bench.NULL_BY_DESIGN)


@pytest.mark.parametrize("family", ["main", "image_families", "chip_probe",
                                    "train_family", "seg_family",
                                    "video_family"])
def test_bench_raises_without_a_card(monkeypatch, family):
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(bench, family)()
