"""Serve an LM with frozen 4-bit weights and batched greedy decoding, on
the PyTorch/CUDA port.

    PYTHONPATH=src python examples/serve_lm_4bit_torch.py [--arch smollm-360m]
    PYTHONPATH=src python examples/serve_lm_4bit_torch.py --arch deepseek-v3-671b --device cpu

Initialises the smoke-sized config of an architecture the port builds,
freezes every FC weight to row-pair-packed 4-bit codes and 4 centroids,
then runs prefill + decode over a request batch, through the serving
launcher's ``serve_lm_config``.

The path is chosen from the config before anything runs.  A dense-family
arch without MLA also serves through the engine (``--engine``, the
default): a ``serving.LMProgram`` (FFN plans per block on the FantastIC4
kernels) registered in a ``ServingFrontend``, prefill and decode steps
arriving as wire rows, its tokens checked against the program's own
``generate`` bit for bit.  Every other arch (moe, MLA) and ``--no-engine``
take the direct ``lm_apply`` loop alone.  On the card the program
launches the hand-written CUDA kernels, on ``--device cpu`` their plain
PyTorch versions; any error while serving ends the example with a
nonzero exit.
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m",
                    choices=serve.lm_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--engine", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="also serve through serving.LMProgram + "
                         "ServingFrontend (dense archs without MLA)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = serve.lm_config(argparse.Namespace(arch=args.arch, smoke=True,
                                             layers=None))
    args.engine = (args.engine and cfg.family == "dense"
                   and cfg.mla is None)
    print(f"{args.arch} (smoke): "
          + ("the engine and the direct loop" if args.engine
             else "the direct loop"))
    out = serve.serve_lm_config(cfg, args)
    print(f"generated {out.shape[1]} tokens for {out.shape[0]} requests:")
    for i, row in enumerate(out):
        print(f"  req{i}: {row.tolist()}")


if __name__ == "__main__":
    main()
