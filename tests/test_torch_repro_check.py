"""``tools/torch_repro_check.py``: its comparison of two child records names
a planted source and passes equal records; one whole run on the CPU (two
child processes at 320x240, two frames, frame 0 recorded) agrees bit for
bit."""

import copy

import torch

from tools import torch_repro_check as rc

torch.set_num_threads(1)

SITE = "larvio_tpu_torch/data/render.py:1"


def _record() -> dict:
    ops = [{"op": "aten::mul.Tensor", "site": "larvio_tpu_torch/pipeline.py:1", "in": ["a"], "out": ["b"]},
           {"op": "aten::index_add", "site": SITE, "in": ["b", "i", "v"], "out": ["c"]},
           {"op": "aten::add.Tensor", "site": "larvio_tpu_torch/pipeline.py:2", "in": ["c"], "out": ["d"]}]
    step = {"input": "x", "out": {"p": "p0"}, "state": {"vio.filter.P": "s0"}}
    return {"frames": ["f0", "f1"], "steps": [step, copy.deepcopy(step)], "ops": ops,
            "kernels": [{"kernel": "describe", "site": "larvio_tpu_torch/models/frontend.py:1", "out": ["k"]}],
            "rerender": {"differ": 0, "first": None, "max_abs": 0.0}, "frame": 1}


def test_compare_passes_equal_records():
    res = rc.compare(_record(), _record())
    assert not res["differs"] and res["op"] is None and not res["sources"] and not res["kernels"]


def test_compare_names_the_planted_site():
    """One operation of the second record gives other outputs from equal
    inputs: the comparison names it first and as the only source; the
    operation after it differs too (its input did), and is no source."""
    a, b = _record(), _record()
    b["ops"][1]["out"] = ["c'"]
    b["ops"][2]["in"], b["ops"][2]["out"] = ["c'"], ["d'"]
    b["steps"][1]["state"]["vio.filter.P"] = "s1"
    res = rc.compare(a, b)
    assert res["differs"]
    assert (res["op"]["index"], res["op"]["op"], res["op"]["site"]) == (1, "aten::index_add", SITE)
    assert list(res["sources"]) == [f"aten::index_add at {SITE}"]
    assert res["step"] == {"index": 1, "leaves": ["vio.filter.P"]}
    assert res["rendered"] is None and res["input"] is None


def test_tool_run_on_cpu_agrees():
    assert rc.main(["--device", "cpu", "--size", "320x240", "--frames", "2", "--frame", "0"]) == 0
