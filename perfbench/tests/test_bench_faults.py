"""A run with its timed path broken underneath reads ``correct`` false:
each fault a cell can have, on the CPU at the rehearsal sizes (the look
for a card skipped), against the cell's own limits. And the control (the
reference at the precision below the configuration's in the program's
place) fails each cell's limits there too."""

import pytest

import run
import control

CASES = [("separate9-eval", "answer"), ("separate9-eval", "half"),
         ("joint-train", "unchanged"), ("joint-train", "half")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_reads_incorrect(workload, fault, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    out = run.run(["--workload", workload, "--seed", "2147483659",
                   "--seconds", "0.5", "--rehearse", "--fault", fault])
    assert out["correct"] is False
    assert list(out)[-1] == "checks"
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload", ["separate9-eval", "joint-train"])
def test_control_fails_the_limits(workload, capsys):
    from harness import manifest
    limits = manifest.find_cell(workload).limits
    row = control.main(["--workload", workload, "--seeds", "4", "--rehearse"])[0]
    nums = {k: v for k, v in row["control"].items() if k in limits}
    assert set(nums) == set(limits)
    assert any(v > limits[k] for k, v in nums.items())


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(tmp_path, monkeypatch):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    out = run.run(["--workload", "separate9-eval", "--seed", "5",
                   "--seconds", "3"])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"scenes_per_s", "scene_ms_p90", "setup_s"}
