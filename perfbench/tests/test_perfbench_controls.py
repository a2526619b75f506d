"""The control of ``correct``: the plain reference computed in the
precision below the configuration's (TF32 for float32, fp8 for bfloat16)
in the program's place must read above the program's sound readings and
fail the cell's limits.  On the CPU at a small size the control is held to
three times the program's reading on some number; on a card, at the cell's
own size, it has to fail the cell's limits (``controls.py`` prints the
readings the limits were set from)."""
import pytest
import torch

from perfbench import bench, controls
from perfbench import data as data_lib
from perfbench.tests.helpers import ROOT, few_threads, small_cell

CELLS = (("micro-lm-100m.train-1k", "float32"), ("granite-moe-1b-a400m.train-4k", "bfloat16"))


@pytest.mark.parametrize("name,dtype", CELLS)
def test_control_reads_above_the_program(name, dtype):
    few_threads()
    cell = small_cell(name, dtype=dtype)
    dev = torch.device("cpu")
    got = controls.program(cell, 21, dev)["readings"]
    batches = bench.batch_list(data_lib.Batches(21, cell.mix, cell.config["vocab_size"], dev),
                               range(cell.mix["checked_steps"]))
    ctl = controls.versus(cell, 21, dev, batches, precision=bench.CONTROL[dtype])
    assert any(ctl[k] >= 3 * got[k] for k in ctl), (ctl, got)


@pytest.mark.card
@pytest.mark.parametrize("name", [c[0] for c in CELLS])
def test_control_fails_the_cell_limits_at_full_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    cell = bench.resolve_cell(ROOT, name)
    dev = torch.device("cuda")
    data = data_lib.Batches(5, cell.mix, cell.config["vocab_size"], dev)
    batches = bench.batch_list(data, range(cell.mix["checked_steps"]))
    ctl = controls.versus(cell, 5, dev, batches, precision=bench.CONTROL[cell.config["torch_dtype"]])
    assert any(v > cell.limits[k] for k, v in ctl.items()), ctl
