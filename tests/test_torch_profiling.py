"""The port's profiling hooks (utils/profiling.py) on the CPU: a
device_trace context writes a Chrome trace into its log directory, with
the program's spans (core/logging.span, as `pg.<name>`) and the ops run
inside them; disabled, it writes nothing."""

import json

import pytest
import torch

from proximalgalerkin_torch.core.logging import span
from proximalgalerkin_torch.utils import device_trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _work():
    a = torch.ones(64, 64, dtype=torch.float64)
    return (a @ a).sum()


def test_trace_written_with_annotation(tmp_path):
    logdir = tmp_path / "trace"
    with device_trace(str(logdir)) as prof:
        with span("signorini_newton_step"):
            _work()
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "pg.signorini_newton_step" in names
    assert any("mm" in str(n) for n in names)
    region = [e for e in events if e.get("name") == "pg.signorini_newton_step"
              and e.get("ph") == "X"]
    assert region and region[0]["dur"] > 0
    assert any(k.key == "pg.signorini_newton_step"
               for k in prof.key_averages())


def test_trace_disabled_writes_nothing(tmp_path):
    logdir = tmp_path / "trace"
    with device_trace(str(logdir), enabled=False) as prof:
        with span("region"):
            _work()
    assert prof is None
    assert not logdir.exists()
