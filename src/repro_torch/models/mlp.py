"""The paper's hardware-conform MLPs (§VI-A): init, freeze and serve.

Mirrors the serving half of the JAX package's ``models/mlp.py``:

* ``mlp_init`` — random EC4T-parameterised layers and BatchNorm state,
  drawn from an explicit ``torch.Generator``;
* ``freeze_mlp`` — ECL-assign the final codes and fold BatchNorm into the
  §V epilogue constants  α₁ = γ/σ,  b' = β + α₁·(bias − μ)  (the JAX
  package's ``mlp.py:185-193``, computed in numpy float32 as there);
* ``mlp_serve`` / ``mlp_serve_int8`` — compatibility wrappers over an
  ``ExecutionPlan``.

The frozen layer dict leaves out the JAX pack's ``format``, ``size_bytes``
and ``crc`` (the codecs and integrity layer are not ported yet).
Training waits for a later slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.paper_mlps import MLPConfig
from ..core import bitplanes, ecl, qat
from ..serving import plans


def mlp_init(cfg: MLPConfig, *, generator: Optional[torch.Generator] = None,
             seed: int = 0, device=None) -> tuple:
    """(params, bn_state) for ``cfg``; weights He-normal from ``generator``
    (a CPU generator seeded with ``seed`` when none is given), then moved
    to ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    params, bn_state = {"layers": []}, {"layers": []}
    d_in = cfg.d_in
    for d_out in cfg.features:
        scale = (2.0 / d_in) ** 0.5
        w = (torch.randn((d_in, d_out), generator=generator) * scale).to(dev)
        layer = {"kernel": qat.make_quant_param(w),
                 "bias": torch.zeros(d_out, device=dev)}
        st = {}
        if cfg.batch_norm:
            layer["bn_gamma"] = torch.ones(d_out, device=dev)
            layer["bn_beta"] = torch.zeros(d_out, device=dev)
            st = {"mean": torch.zeros(d_out, device=dev),
                  "var": torch.ones(d_out, device=dev)}
        params["layers"].append(layer)
        bn_state["layers"].append(st)
        d_in = d_out
    return params, bn_state


def freeze_dense_layer(codes: torch.Tensor, omega: torch.Tensor, *,
                       alpha1=None, bias=None, alpha2: Optional[float] = None,
                       activation: Optional[str] = None) -> dict:
    """Pack one ECL-coded (K, N) layer into the serving layer dict; odd K
    grows a zero code row before row-pair packing."""
    k, n = codes.shape
    dev = codes.device
    if k % 2:
        codes = torch.cat([codes, torch.zeros((1, n), dtype=torch.uint8,
                                              device=dev)], dim=0)
    a1 = np.ones(n, np.float32) if alpha1 is None \
        else np.asarray(alpha1, np.float32)
    b = np.zeros(n, np.float32) if bias is None else np.asarray(bias, np.float32)
    return {
        "packed": bitplanes.pack_codes_rows(codes).contiguous(),
        "omega": omega.to(torch.float32),
        "alpha1": torch.from_numpy(a1).to(dev),
        "bias": torch.from_numpy(b).to(dev),
        "alpha2": torch.tensor(1.0 if alpha2 is None else alpha2,
                               dtype=torch.float32, device=dev),
        "shape": (k, n),
        "activation": activation,
    }


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def freeze_mlp(params: dict, qstate: dict, bn_state: dict, lam: float,
               act_bits: Optional[int] = None) -> dict:
    """ECL-quantize every layer and fold BN into the epilogue constants."""
    layers = []
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        node = layer["kernel"]
        probs = qstate["layers"][i]["kernel"]["probs"]
        codes = ecl.assign(node["w"], node["omega"], probs, lam)
        m = codes.shape[1]
        if "bn_gamma" in layer:
            st = bn_state["layers"][i]
            inv_sigma = 1.0 / np.sqrt(_np(st["var"]) + 1e-5)
            alpha1 = _np(layer["bn_gamma"]) * inv_sigma
            bias = (_np(layer["bn_beta"])
                    + alpha1 * (_np(layer["bias"]) - _np(st["mean"])))
        else:
            alpha1 = np.ones((m,), np.float32)
            bias = _np(layer["bias"])
        layers.append(freeze_dense_layer(
            codes, node["omega"], alpha1=alpha1, bias=bias,
            activation="relu" if i < n - 1 else None))
    return {"layers": layers, "act_bits": act_bits}


def _pack_device(pack: dict) -> torch.device:
    return pack["layers"][0]["packed"].device


def _compat_plan(pack: dict, *, use_kernel: bool, fused: bool,
                 act_dtype: str, calib: Optional[dict],
                 block_m: Optional[int], double_buffer: bool):
    """``fused=True`` is the batch-tiled megakernel at every batch size
    (``ws_bucket_rows=0``), as in the JAX package."""
    mode = "oracle" if not use_kernel else ("fused" if fused
                                            else "per_layer")
    return plans.get_plan(pack, mode=mode, act_dtype=act_dtype, calib=calib,
                          double_buffer=double_buffer, block_m=block_m,
                          ws_bucket_rows=0, device=_pack_device(pack))


def mlp_serve(pack: dict, x, *, use_kernel: bool = True, fused: bool = True,
              block_m: Optional[int] = None, double_buffer: bool = False,
              device=None) -> torch.Tensor:
    """End-to-end fp32 inference on the frozen pack.  ``device`` defaults
    to CUDA (raising without it) and must be where the pack lives."""
    _check_device(pack, device)
    plan = _compat_plan(pack, use_kernel=use_kernel, fused=fused,
                        act_dtype="float32", calib=None, block_m=block_m,
                        double_buffer=double_buffer)
    return plan.run(x)


def calibrate_act_scales(pack: dict, x_calib) -> dict:
    return plans.calibrate_act_scales(pack, x_calib)


def mlp_serve_int8(pack: dict, calib: dict, x, *, use_kernel: bool = True,
                   fused: bool = True, block_m: Optional[int] = None,
                   double_buffer: bool = False, device=None) -> torch.Tensor:
    """Serving with int8 inter-layer activations (paper §VI-C): layer i
    emits round(y/s_i) clipped to int8 and layer i+1 folds s_i into α₁;
    the final layer returns float logits."""
    _check_device(pack, device)
    plan = _compat_plan(pack, use_kernel=use_kernel, fused=fused,
                        act_dtype="int8", calib=calib, block_m=block_m,
                        double_buffer=double_buffer)
    return plan.run(x)


def _check_device(pack: dict, device) -> None:
    dev = resolve_device(device)
    if _pack_device(pack).type != dev.type:
        raise ValueError(f"pack lives on {_pack_device(pack)}, serving was "
                         f"asked for {dev}")
