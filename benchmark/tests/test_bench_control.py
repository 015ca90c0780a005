"""The control, the reference one precision down (float8 operands for the
bfloat16 configurations), put in the program's place, fails the check where
the program in its own precision passes: at a tiny size on the CPU.  Its
readings at the cells' own sizes come from ``python -m benchmark.calibrate``
on the card (PERF.md)."""

import pytest
import torch

from benchmark import check, generate
from benchmark.manifest import find_cell, work_module, load_json
from benchmark.reference import lowp
from benchmark.tests.conftest import DATA


def test_float8_rounding_is_coarser_than_bfloat16():
    x = torch.randn(4096, dtype=torch.float64)
    e8 = ((lowp.to_float8(x) - x).norm() / x.norm()).item()
    e16 = ((x.to(torch.bfloat16).double() - x).norm() / x.norm()).item()
    assert e8 > 8 * e16 and e8 < 0.1


def test_the_mode_rounds_products_forward_and_backward():
    a = torch.randn(32, 32, requires_grad=True)
    b = torch.randn(32, 32)
    with lowp.Float8Operands():
        y = a @ b
        y.sum().backward()
    assert not torch.equal(y, a.detach() @ b)
    assert not torch.equal(a.grad, torch.ones(32, 32) @ b.T)


@pytest.mark.parametrize("workload", ["f32_train"])
def test_control_fails_where_the_program_passes_train(workload):
    m = load_json(DATA + "/BENCHMARK.json")
    cell = find_cell(m, workload, DATA)
    runner = work_module("clips")
    seed = 21
    fields = runner.model_fields(cell, seed)
    pool = generate.make_clips(cell.traffic, seed, "cpu")
    ref = runner.reference_readings(fields, seed, pool, "cpu")
    ctl = runner.reference_readings(fields, seed, pool, "cpu", control=True)
    ok, checks = check.verdict(runner.compare(ctl, ref), cell.limits)
    assert not ok, checks


def test_control_fails_where_the_program_passes_serving():
    m = load_json(DATA + "/BENCHMARK.json")
    cell = find_cell(m, "f32_infer", DATA)
    runner = work_module("videos")
    seed = 22
    fields = runner.model_fields(cell)
    pool = generate.make_videos(cell.traffic, seed, "cpu")
    sample = runner.serving_order(pool, seed)[:cell.traffic["sample"]]
    served = {vi: [None] * len(pool[vi].texts) for vi in sample}
    gaps = runner.reference_gaps(fields, seed, pool, served, cell.traffic, "cpu", put="control")
    ok, checks = check.verdict(gaps, cell.limits)
    assert not ok, checks
