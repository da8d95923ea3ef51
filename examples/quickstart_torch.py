"""Quickstart for the PyTorch/CUDA port: the FantastIC4 pipeline end to end.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain versions

1. ECL-quantize weight matrices to 16 subset-sum centroids (4 bit-planes
   × 4 basis values ω — paper eq. 1), through the grouped ECL op,
2. pick the cheapest lossless format (CSR / bitmask / dense4),
3. freeze them into a serving pack and resolve an ``ExecutionPlan``
   (mode, row tile, bucket → kernel schedule — decided once, not per call),
4. serve a batch through the plan and ragged requests through the
   micro-batcher (queue → bucket → plan), checking both against the
   plain PyTorch oracle plan (fp32 gate ``atol=1e-3, rtol=1e-4``).

On the card the plan launches the hand-written CUDA kernels; on the CPU
their plain PyTorch versions.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device, serving
from repro_torch.core import bitplanes, ecl, formats
from repro_torch.models.mlp import freeze_dense_layer

DIMS = (256, 128, 10)                      # a 2-layer MLP stack
ATOL, RTOL = 1e-3, 1e-4


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # --- "trained" weights: heavy-tailed (laplacian), like real
    # post-training weight distributions, so low-entropy coding finds zeros
    layers = []
    for i, (k, n) in enumerate(zip(DIMS[:-1], DIMS[1:])):
        w = torch.from_numpy((rng.laplace(size=(k, n)) * 0.03)
                             .astype(np.float32)).to(dev)
        omega = bitplanes.init_omega_from_weights(w)   # 4 basis centroids
        codes, probs = ecl.ecl_fit(w, omega, lam=0.5, iters=12)
        entropy = float(ecl.entropy_bits(ecl.histogram(codes)))
        print(f"layer {i}: sparsity {float(ecl.sparsity(codes)):.1%}, "
              f"entropy {entropy:.2f} bits/weight (vs 4.0 uncoded)")

        # --- multiple lossless formats; the cheapest wins (contribution 4)
        host = codes.cpu().numpy()
        best = formats.select_format(host)
        print(f"  selected {best}: {formats.compression_ratio(host):.1f}x "
              "smaller than fp32")
        assert np.array_equal(formats.decode(formats.encode(host, best)),
                              host)
        layers.append(freeze_dense_layer(
            codes, omega, activation="relu" if i < len(DIMS) - 2 else None))
    pack = {"layers": layers, "act_bits": None}

    # --- ONE execution plan per pack: the kernel schedule per batch bucket
    # (weight-stationary ≤ 8 rows, batch-tiled megakernel above) up front
    plan = serving.build_plan(pack, mode="auto", device=dev)
    oracle = serving.build_plan(pack, mode="oracle", device=dev)
    d = plan.describe()
    print(f"plan: {d['resolved_mode']} on {d['device']} (buckets "
          f"{d['bucket_sizes']}, block_m {d['block_m']}), batch 1 -> "
          f"{plan.mode_label(1)}")

    x = torch.from_numpy(rng.normal(size=(8, DIMS[0])).astype(np.float32))
    y = plan.run(x.to(dev))
    torch.testing.assert_close(y, oracle.run(x.to(dev)), atol=ATOL,
                               rtol=RTOL)
    print(f"serving plan matches the oracle (output {tuple(y.shape)})")

    # --- ragged traffic through the micro-batcher: requests of 1-4 rows
    # coalesce into one power-of-two bucket launch, results scatter back
    batcher = serving.MicroBatcher(plan)
    reqs = [rng.normal(size=(r, DIMS[0])).astype(np.float32)
            for r in (1, 4, 2, 1)]
    for req, out in zip(reqs, batcher.serve(reqs)):
        np.testing.assert_allclose(
            out, oracle.run(torch.from_numpy(req).to(dev)).cpu().numpy(),
            atol=ATOL, rtol=RTOL)
    st = batcher.stats
    print(f"micro-batcher served {st['requests']} ragged requests "
          f"({st['rows']} rows) in {st['flushes']} launch(es), bucket hist "
          f"{st['bucket_hist']}")


if __name__ == "__main__":
    main()
