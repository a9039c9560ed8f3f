"""The port's ops tools on the CPU: `train.MetricsLogger` against the JAX
package's (the same JSON lines and console line from the same metrics),
`utils.assert_finite` / `debug_nans`, and `utils.annotate` / `trace` /
`step_timer`."""

import io
import json
import math

import jax.numpy as jnp
import pytest
import torch

from xclip_tpu.train import MetricsLogger as JMetricsLogger
from xclip_tpu_torch import utils
from xclip_tpu_torch.train import MetricsLogger

from test_torch_train import TINY
import torch_one_thread  # noqa: F401


def _metrics(i):
    return {"loss": 1.5 - 0.1 * i, "cl_loss": 1.25 - 0.1 * i,
            "temperature": math.e, "grad_norm": 0.5 + i,
            "text_ssl_loss": 0.0}


def _log(logger_cls, path, wrap, flush_every):
    out = io.StringIO()
    with logger_cls(str(path), flush_every=flush_every,
                    print_to=out) as logger:
        for i in range(5):
            metrics = {k: wrap(v) for k, v in _metrics(i).items()}
            metrics["bn_updates"] = {"x": wrap(1.0)}    # not a scalar
            logger.log(i, metrics)
    return path.read_text(), out.getvalue()


@pytest.mark.parametrize("flush_every", [1, 2, 20])
def test_metrics_logger_writes_what_jax_writes(tmp_path, flush_every):
    want = _log(JMetricsLogger, tmp_path / "jax.jsonl",
                lambda v: jnp.asarray(v, jnp.float32), flush_every)
    got = _log(MetricsLogger, tmp_path / "torch.jsonl",
               lambda v: torch.tensor(v, dtype=torch.float32), flush_every)
    assert got == want
    lines = [json.loads(line) for line in got[0].splitlines()]
    assert [r["step"] for r in lines] == list(range(5))
    assert set(lines[0]) == {"step", *_metrics(0)}


def test_assert_finite_names_each_bad_leaf():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Linear(2, 1))
    utils.assert_finite(model, "params")
    with torch.no_grad():
        model[1].weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="params .* 1/weight$"):
        utils.assert_finite(model, "params")
    tree = {"a": torch.ones(2), "b": {"c": torch.tensor([1.0, float("inf")]),
                                      "d": torch.arange(3)}}
    with pytest.raises(FloatingPointError, match="at: b/c$"):
        utils.assert_finite(tree, "grads")


def test_debug_nans_raises_in_the_backward():
    x = torch.tensor([-1.0], requires_grad=True)
    with utils.debug_nans():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    with utils.debug_nans(False):
        torch.sqrt(x).sum().backward()


def test_annotate_and_trace_on_the_cpu(tmp_path):
    import xclip_tpu_torch
    clip = xclip_tpu_torch.CLIP(**TINY, device="cpu")
    text = torch.randint(1, 100, (2, 16))
    image = torch.randn(2, 3, 48, 48)
    with utils.trace(str(tmp_path / "trace")):
        with utils.annotate("xclip_forward"):
            clip(text, image)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "xclip_forward" in names
    timed = utils.step_timer(lambda a: a * 2)
    out, seconds = timed(torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0)) and seconds >= 0
