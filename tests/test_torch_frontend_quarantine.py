"""The port's frontend when one stream quarantines a model while another
stream's launch of the same model fails.

A cache-managed model (``PackCache``) that one stream quarantines is
unregistered, so its plan handle no longer resolves.  A launch of it that
was in flight on another stream and fails then walks the degradation
ladder: its fallback rung must find the model gone and end there (the
quarantine has already failed the model's requests with their typed
cause), not raise the cache's ``KeyError`` out of the worker, which would
end the frontend for every model.
"""
import numpy as np
import pytest

from repro_torch import serving
from test_torch_frontend import _FakeClock
from test_torch_mlp_serving import _rand_pack

DIMS = (16, 24, 8)


def _frontend():
    cache = serving.PackCache(device="cpu")
    fe = serving.ServingFrontend(
        cache=cache, streams=2, clock=_FakeClock(),
        retry_policy=serving.RetryPolicy(max_retries=0))
    fe.register_pack("m", _rand_pack(DIMS, seed=30),
                     plan_kwargs={"mode": "oracle"})
    fe.register_pack("other", _rand_pack(DIMS, seed=31),
                     plan_kwargs={"mode": "oracle"})
    return fe, cache


def test_a_failure_after_another_streams_quarantine_ends_quietly():
    fe, cache = _frontend()
    batcher = fe.registry.batcher("m")
    fe._quarantine("m", batcher, RuntimeError("stream 1 gave up on m"))
    with pytest.raises(KeyError):
        batcher.plan.buckets            # unregistered: nothing resolves
    # stream 0's launch of "m", in flight during the quarantine, fails
    assert fe._degrade("m", batcher, RuntimeError("stream 0")) is None
    assert fe.stats["quarantined"] == ["m"] and fe._error is None
    x = np.zeros((1, DIMS[0]), np.float32)
    with fe:
        assert fe.submit("other", x).result(30.0).y.shape == (1, DIMS[-1])
        with pytest.raises(serving.Rejected):
            fe.submit("m", x).result(30.0)


def test_the_same_lookup_error_of_a_live_model_still_raises(monkeypatch):
    """Only a quarantined model's failure ends there: a lookup error of a
    model still registered is a fault, and propagates."""
    fe, _ = _frontend()
    batcher = fe.registry.batcher("m")

    def gone(*_):
        raise KeyError("no such plan")
    monkeypatch.setattr(type(batcher.plan), "buckets", property(gone))
    with pytest.raises(KeyError, match="no such plan"):
        fe._degrade("m", batcher, RuntimeError("stream 0"))
