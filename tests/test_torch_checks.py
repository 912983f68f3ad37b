"""``python -m vm_asr_tpu_torch.checks`` on the CPU: every check runs the
plain fp32 route against its fp64 witness, says that no kernel ran, and
launches none; without ``--device cpu`` it asks for the card."""

import pytest
import torch

from vm_asr_tpu_torch import checks
from vm_asr_tpu_torch.ops import linear_recurrence, selective_scan_fused

from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("argv", [["--skip-bench"], ["--skip-bench", "--grid"]])
def test_cpu_checks_pass_and_say_no_kernel_ran(argv, capsys):
    before = (linear_recurrence.launches, selective_scan_fused.launches)
    assert checks.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert "no kernel ran" in out
    assert "all checks passed on the CPU" in out
    assert "every kernel against its plain version" not in out
    assert ("[grid" in out) == ("--grid" in argv)
    assert (linear_recurrence.launches, selective_scan_fused.launches) == before


def test_checks_default_to_the_card():
    if torch.cuda.is_available():
        assert checks.resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checks.main(["--skip-bench"])


def test_launch_guard_fails_a_check_whose_kernel_did_not_run():
    """On the card a check fails unless its wrappers counted the launches it
    expects; the guard is exercised here with the counters alone."""
    guard = checks._Launches(torch.device("cuda"), linear_recurrence=1)
    with pytest.raises(AssertionError, match="expected"):
        with guard:
            pass
    before = linear_recurrence.launches
    try:
        with guard:
            linear_recurrence.launches += 1
    finally:
        linear_recurrence.launches = before
