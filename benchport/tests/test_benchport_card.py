"""Each cell end to end on the card, short windows: correct, and the traced
run reads device time. Skips without a CUDA device (decided in the test)."""

import json

import pytest

import run as bench_run

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["binaural714_loud_fleet8",
                                      "opus714_ssJ_serial"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_card(capsys, workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "an NVIDIA GPU")
    from harness import manifest

    chips = manifest.Cell(workload).cell["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"the cell needs {chips} cards")
    rc = bench_run.main(["--workload", workload, "--seed", "123456789012",
                         "--seconds", "3", "--trace", str(trace)],
                        root=ROOT)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    if trace:
        assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
