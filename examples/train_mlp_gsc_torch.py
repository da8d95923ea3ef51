"""End to end on the PyTorch/CUDA port: train the paper's MLP-GSC
with EC4T, freeze it, serve it.

    PYTHONPATH=src python examples/train_mlp_gsc_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_mlp_gsc_torch.py --steps 20 --device cpu

The paper's own experiment shape (§VI-A Google Speech Commands): a
512-512-256-256-128-128-12 MLP with BatchNorm on the synthetic
classification task, trained with the entropy-constrained 4-bit method
(``launch.train.train_mlp``: every step's fake-quant forward and
probability update one grouped launch of the ECL kernel on the card),
then frozen into the §V serving pack (α₁⊙(x·Ŵ)+b → ReLU → α₂) with a
lossless format chosen per layer.  Prints the Table-II row of the run
(accuracy, sparsity, entropy, compression ratio) and checks the served
logits against the eval-mode training forward (``atol=rtol=1e-2``, as the
JAX package's example does).
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs.paper_mlps import MLP_GSC
from repro_torch.launch.train import serving_check, train_mlp
from repro_torch.models import mlp as M


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"training MLP-GSC ({'-'.join(map(str, MLP_GSC.features))}) "
          f"with EC4T, λ={args.lam}, on {dev} ...")
    params, qs, bn, metrics = train_mlp(MLP_GSC, lam=args.lam,
                                        steps=args.steps, device=dev)
    print(f"accuracy {metrics['acc']:.1%}  sparsity {metrics['sparsity']:.1%}"
          f"  entropy {metrics['entropy_bits']:.2f} bits/weight")

    pack = M.freeze_mlp(params, qs, bn, lam=args.lam)
    summ = M.pack_compression_summary(pack)
    print(f"frozen: {summ['compression_ratio']:.1f}x compression, "
          f"formats per layer: {summ['formats']}")

    err = serving_check(MLP_GSC, params, qs, bn, pack, args.lam,
                        lambda x: M.mlp_serve(pack, x, device=dev))
    print(f"serving path verified: max |served - eval| {err:.2e}")


if __name__ == "__main__":
    main()
