"""The port's ``ecl_fit``, the port's quickstart example and the serving
launcher's frontend flags.

* ``core.ecl.ecl_fit`` gives the JAX ``ecl_fit``'s codes and probabilities
  on the same (w, ω, λ) (codes exact; probabilities exact: both are
  counts over the same codes divided alike);
* ``examples/quickstart_torch.py --device cpu`` runs and checks itself,
  as do ``examples/serve_lm_4bit_torch.py`` (through the launcher's
  ``serve_lm_config``: for a dense arch the engine's tokens against
  ``LMProgram.generate``, the direct loop alone for moe and MLA archs) and
  ``examples/train_mlp_gsc_torch.py`` at a few steps (served logits
  within 1e-2 of the eval forward);
* ``launch/serve.py`` refuses the same flag combinations with the JAX
  launcher's messages, and ``--engine --async`` serves several packs
  through the frontend on the CPU with the integrity, cold-tier, fault and
  stream flags.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplanes as jbp
from repro.core import ecl as jecl
from repro_torch.core import bitplanes as tbp
from repro_torch.core import ecl as tecl
from repro_torch.launch import serve as tserve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape,lam,iters", [((48, 33), 0.5, 12),
                                             ((7, 5), 0.02, 3),
                                             ((3, 20, 9), 0.3, 6)],
                         ids=["laplace", "small", "batched"])
def test_ecl_fit_equals_the_jax_ecl_fit(shape, lam, iters):
    rng = np.random.default_rng(sum(shape))
    w = (rng.laplace(size=shape) * 0.03).astype(np.float32)
    omega = np.array(jbp.init_omega_from_weights(jnp.asarray(w)))
    np.testing.assert_array_equal(
        tbp.init_omega_from_weights(torch.from_numpy(w)).numpy(), omega)
    jc, jp = jecl.ecl_fit(jnp.asarray(w), jnp.asarray(omega), lam,
                          iters=iters)
    tc, tp = tecl.ecl_fit(torch.from_numpy(w), torch.from_numpy(omega), lam,
                          iters=iters)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tc.dtype == torch.uint8 and tp.shape == (*shape[:-2], 16)


def test_quickstart_example_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "quickstart_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env)
    assert proc.returncode == 0, proc.stderr
    assert "serving plan matches the oracle" in proc.stdout
    assert "micro-batcher served 4 ragged requests" in proc.stdout


@pytest.mark.parametrize("argv,message", [
    (["--streams", "0"], "--streams must be >= 1"),
    (["--streams", "2"], "--streams applies to the async frontend"),
    (["--shard"], "--shard is not ported yet"),
    (["--tier", "latency"], "--tier/--max-delay/--max-queued/--inject-fault"),
    (["--max-hot-models", "2"], "--max-hot-models/--hot-bytes apply"),
    (["--verify-launch"], "--flip-rate/--scrub-interval/--verify-launch"),
    (["--engine", "--async", "--flip-rate", "0.1"],
     "--flip-rate corrupts live weights"),
    (["--multi", "mlp-hr"], "--multi requires --engine --async"),
    (["--async"], "--async requires --engine"),
])
def test_launcher_refuses_flags_like_the_jax_launcher(argv, message):
    with pytest.raises(SystemExit, match=message):
        tserve.main(argv + ["--device", "cpu"])


def test_launcher_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", "lenet-300-100", "--batch", "2"])


def test_launcher_serves_several_packs_through_the_frontend(capsys):
    tserve.main(["--arch", "lenet-300-100", "--batch", "6", "--iters", "1",
                 "--engine", "--async", "--multi", "mlp-hr",
                 "--tier", "standard,throughput", "--verify-launch",
                 "--max-hot-models", "1", "--flip-rate", "0.2",
                 "--inject-fault", "0.1", "--scrub-interval", "5",
                 "--streams", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "pack cache: hot budget 1 models" in out
    assert "async frontend [lenet-300-100]" in out
    assert "async frontend [mlp-hr]" in out
    assert "integrity:" in out and "stream 1:" in out
    with pytest.raises(SystemExit, match="duplicates"):
        tserve.main(["--arch", "mlp-hr", "--engine", "--async", "--multi",
                     "mlp-hr", "--device", "cpu"])


def test_elastic_restart_example_runs_on_the_cpu():
    """``examples/elastic_restart_torch.py``: train, get preempted by a
    SIGTERM, resume from the checkpoint bitwise."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "examples", "elastic_restart_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env)
    assert proc.returncode == 0, proc.stderr
    assert "preempted at step" in proc.stdout
    assert "elastic restart OK" in proc.stdout


def _run_example(name, *argv):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", name), *argv,
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v3-671b"])
def test_serve_lm_4bit_example_runs_on_the_cpu(arch):
    """The dense arch through the engine (its tokens checked against
    ``LMProgram.generate`` by the launcher), deepseek-v3 with MLA through
    the direct loop alone: the path is chosen from the config."""
    out = _run_example("serve_lm_4bit_torch.py", "--arch", arch, "--batch",
                       "2", "--prompt-len", "6", "--max-new", "3")
    assert "generated 3 tokens for 2 requests" in out
    assert ("engine (LM program)" in out) == (arch == "smollm-360m")
    assert ("decode bit-identical to the direct generate loop" in out) == (
        arch == "smollm-360m")


def test_train_mlp_gsc_example_runs_on_the_cpu():
    out = _run_example("train_mlp_gsc_torch.py", "--steps", "4")
    assert "training MLP-GSC (512-512-256-256-128-128-12)" in out
    assert "compression, formats per layer" in out
    assert "serving path verified" in out
