"""The port's kernel modules vs the JAX package's Pallas kernels.

On the CPU each port wrapper takes its kernel's plain PyTorch version (the
CUDA kernels run only on the card, see ``chip_smoke.py``); the JAX side
runs the real Pallas bodies with ``interpret=True``, as the JAX tests do.
Same numpy inputs on both sides.

Gates (the repo's serving gates, ``tests/test_serving_parity.py:82,134``):
fp32 ``atol=1e-3, rtol=1e-4``; int8 relative max-abs error ``< 5e-3``
(the reference's own int8 paths are not bitwise equal to each other, see
ROADMAP queue 3).  Inside the port, the int8 outputs of the chain and of
every fused schedule are bitwise equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplanes as jbp
from repro.kernels import ops as jops
from repro.kernels.fantastic4_matmul import fantastic4_matmul_pallas
from repro.serving.plans import calibrate_act_scales as j_calibrate
from repro_torch.convert import pack_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels import fantastic4_fused_mlp as ffm
from repro_torch.kernels import fantastic4_matmul as fm
from repro_torch.kernels import ops as tops
from repro_torch.kernels.slices import slice_bytes, slice_count, slice_width

STACKS = {"odd": (33, 40, 24, 10), "even": (64, 48, 32, 12)}
SCHEDULES = ("batch_tiled", "db", "ws", "stream")


def _np_pack(dims, seed=0):
    """numpy frozen pack at BN-realistic magnitudes (activations O(1))."""
    rng = np.random.default_rng(seed)
    layers = []
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        codes = rng.integers(0, 16, size=(k + (k % 2), n)).astype(np.uint8)
        if k % 2:
            codes[-1] = 0
        layers.append({
            "packed": np.asarray(jbp.pack_codes_rows(jnp.asarray(codes))),
            "omega": (rng.normal(size=4) / np.sqrt(k)).astype(np.float32),
            "alpha1": (rng.normal(size=n) * 0.5).astype(np.float32),
            "bias": (rng.normal(size=n) * 0.1).astype(np.float32),
            "alpha2": np.float32(rng.uniform(0.5, 1.5)),
            "shape": (k, n),
            "activation": "relu" if i < len(dims) - 2 else None,
        })
    return {"layers": layers, "act_bits": None}


def _jax_pack(pack):
    return {"layers": [{k: (jnp.asarray(v) if isinstance(
        v, (np.ndarray, np.generic)) else v) for k, v in l.items()}
        for l in pack["layers"]], "act_bits": None}


def _check_fp32(got, want, tag=""):
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4, err_msg=tag)


def _check_int8(got, want, tag=""):
    rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert rel < 5e-3, (tag, rel)


@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
@pytest.mark.parametrize("m,k,n", [(1, 32, 24), (7, 64, 130), (40, 96, 12)])
def test_matmul_plain_vs_pallas(m, k, n, activation):
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = np.asarray(jbp.pack_codes_rows(jnp.asarray(
        rng.integers(0, 16, size=(k, n)).astype(np.uint8))))
    om = (rng.normal(size=4) / np.sqrt(k)).astype(np.float32)
    a1 = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    a2 = np.float32(0.8)
    want = np.asarray(fantastic4_matmul_pallas(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(om),
        jnp.asarray(a1), jnp.asarray(b), jnp.asarray(a2),
        activation=activation, interpret=True))
    t = torch.from_numpy
    got = fm.fantastic4_matmul(t(x), t(packed), t(om), t(a1), t(b),
                               torch.tensor(a2), activation=activation)
    _check_fp32(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), fm.fantastic4_matmul_plain(
            t(x), t(packed), t(om), t(a1), t(b), torch.tensor(a2),
            activation=activation).numpy())


@pytest.mark.parametrize("stack,batch", [("odd", 1), ("even", 16)])
def test_chain_plain_vs_pallas(stack, batch):
    dims = STACKS[stack]
    pack = _np_pack(dims, seed=batch)
    jp, tp = _jax_pack(pack), pack_from_numpy(pack, device="cpu")
    x = np.random.default_rng(batch).normal(size=(batch, dims[0])).astype(
        np.float32)
    scales = j_calibrate(jp, jnp.asarray(x))["act_scales"]
    _check_fp32(tops.fantastic4_mlp_chain(torch.from_numpy(x),
                                          tp["layers"]).numpy(),
                np.asarray(jops.fantastic4_mlp_chain(
                    jnp.asarray(x), jp["layers"], interpret=True)))
    _check_int8(tops.fantastic4_mlp_chain_int8(
        torch.from_numpy(x), tp["layers"], scales).numpy(),
        np.asarray(jops.fantastic4_mlp_chain_int8(
            jnp.asarray(x), jp["layers"], scales, interpret=True)))


@pytest.mark.parametrize("stack", sorted(STACKS))
@pytest.mark.parametrize("batch", [1, 12])
@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
def test_fused_schedules_vs_pallas(stack, batch, act_dtype):
    dims = STACKS[stack]
    pack = _np_pack(dims, seed=3 + batch)
    jp, tp = _jax_pack(pack), pack_from_numpy(pack, device="cpu")
    x = np.random.default_rng(batch).normal(size=(batch, dims[0])).astype(
        np.float32)
    scales = j_calibrate(jp, jnp.asarray(x))["act_scales"] \
        if act_dtype == "int8" else None
    outs = {}
    for sched in SCHEDULES:
        bm = {"stream": 8, "db": 16}.get(sched)
        want = np.asarray(jops.fantastic4_mlp_fused(
            jnp.asarray(x), jp["layers"], interpret=True, schedule=sched,
            block_m=bm, act_dtype=act_dtype, act_scales=scales))
        got = tops.fantastic4_mlp_fused(
            torch.from_numpy(x), tp["layers"], schedule=sched, block_m=bm,
            act_dtype=act_dtype, act_scales=scales).numpy()
        assert got.shape == (batch, dims[-1])
        (_check_fp32 if act_dtype == "float32" else _check_int8)(
            got, want, f"{sched} {stack} b={batch}")
        outs[sched] = got
    if act_dtype == "int8":
        chain = tops.fantastic4_mlp_chain_int8(torch.from_numpy(x),
                                               tp["layers"], scales).numpy()
        for sched, got in outs.items():
            np.testing.assert_array_equal(got, chain, err_msg=sched)


def test_ws_operands_plain_vs_pallas():
    """The stacked ws/stream operands the port builds serve the same
    function as the reference's kernels on the reference's operands."""
    from repro.kernels import fantastic4_fused_mlp as jffm
    dims = STACKS["odd"]
    pack = _np_pack(dims, seed=9)
    jp, tp = _jax_pack(pack), pack_from_numpy(pack, device="cpu")
    shapes = tuple(l["shape"] for l in pack["layers"])
    acts = tuple(l["activation"] for l in pack["layers"])
    x = np.random.default_rng(9).normal(size=(6, dims[0])).astype(np.float32)
    jst = jffm.build_ws_operands(
        *[tuple(l[k] for l in jp["layers"]) for k in
          ("packed", "omega", "alpha1", "bias", "alpha2")],
        shapes=shapes, activations=acts)
    want = np.asarray(jffm.fantastic4_fused_mlp_stream_pallas(
        jnp.asarray(x), *jst, shapes=shapes, activations=acts, block_m=8,
        interpret=True))
    tst = ffm.build_ws_operands(
        *[tuple(l[k] for l in tp["layers"]) for k in
          ("packed", "omega", "alpha1", "bias", "alpha2")],
        shapes=shapes, activations=acts)
    assert tst[0].shape == (len(shapes), 20, 40)     # D = widest even dim
    for plain in (ffm.fantastic4_fused_mlp_ws_plain,
                  ffm.fantastic4_fused_mlp_stream_plain):
        _check_fp32(plain(torch.from_numpy(x), *tst, shapes=shapes).numpy(),
                    want)


GSC = (512, 512, 512, 256, 256, 128, 128, 12)


def _shapes(dims):
    return tuple(zip(dims[:-1], dims[1:]))


@pytest.mark.parametrize("dims,tile,ws", [
    (GSC, 32, True), ((512, 512, 256, 128, 12), 32, True),
    ((784, 300, 100, 10), 32, True), ((33, 40, 24, 10), 32, True),
    ((8192, 64, 10), None, False)])
def test_fits_express_shared_memory(dims, tile, ws):
    """The cluster kernels' fits are their per-CTA shared memory -- the
    mbarriers, a descriptor and a codebook per layer, two input buffers of
    rows x input_stride fp32 and the code slices -- against the 232,448
    bytes of a Hopper block; row tiles stop at the kernel's 32 rows.
    stream holds activations in global memory and one row tile and two
    code slices on chip: it fits every stack, an 8192-wide input with
    fewer rows a tile than block_m."""
    shapes = _shapes(dims)
    assert ffm.max_fused_block_m(shapes) == tile
    ldx = ffm.input_stride(shapes)
    sb = ffm.stack_slice_bytes(shapes)
    n = len(shapes)
    assert ffm.fused_mlp_smem_bytes(shapes, 32) == \
        32 + (80 + 64) * n + 2 * 4 * 32 * ldx + max(sb)
    assert ffm.fused_mlp_smem_bytes(shapes, 32, double_buffer=True) == \
        32 + (80 + 64) * n + 2 * 4 * 32 * ldx + 2 * max(sb)
    assert ffm.ws_mlp_smem_bytes(shapes, rows=8) == (
        -(-8 * (n + 2) // 16) * 16 + (80 + 64) * n + 2 * 4 * 8 * ldx
        + sum(sb))
    assert ffm.ws_mlp_fits(shapes, rows=8) == ws
    assert ffm.stream_mlp_fits(shapes, rows=256, block_m=8)
    assert ffm.stream_tile_rows(shapes, 256, 8) == (8 if ws else 3)
    assert ffm.stream_mlp_smem_bytes(shapes, 256, 8) <= ffm.SMEM_BUDGET_BYTES
    for fits in (ffm.ws_mlp_fits(shapes, rows=8, smem_budget_bytes=1),
                 ffm.stream_mlp_fits(shapes, rows=8, smem_budget_bytes=1),
                 ffm.fused_mlp_fits(shapes, block_m=8, smem_budget_bytes=1)):
        assert not fits


def _tables(stack, kind, cluster):
    """A pack's LayerTable as the tiled or the ws (stacked) kernels get it,
    built on the CPU, with each layer's (packed codes, K, N)."""
    pack = pack_from_numpy(_np_pack(stack, seed=len(stack)), device="cpu")
    layers = pack["layers"]
    shapes = tuple(l["shape"] for l in layers)
    cols = [tuple(l[k] for l in layers) for k in
            ("packed", "omega", "alpha1", "bias", "alpha2")]
    acts = tuple(l["activation"] for l in layers)
    if kind == "tiled":
        table = ffm.tiled_layer_table(*cols, shapes=shapes, activations=acts,
                                      act_dtype="float32", cluster=cluster)
        packs = [l["packed"] for l in layers]
    else:
        st = ffm.build_ws_operands(*cols, shapes=shapes, activations=acts)
        assert st[0].shape[-1] == ffm.stack_width(shapes)   # ldp = D
        table = ffm.stacked_layer_table(*st, shapes=shapes, cluster=cluster)
        packs = list(st[0])
    rows = table.tensor.numpy().view(ffm.DESC_DTYPE)
    return table, shapes, packs, rows


SLICE_STACKS = {"gsc": GSC, "odd": STACKS["odd"],
                "odd-widths": (33, 41, 25, 9)}


def _unslice(slices, k, n_end, n_slices):
    """The (k/2, n_slices·W) packed codes a layer's slices hold, slice after
    slice: each is (ceil(k/8), W, 4) bytes, four packed rows a word."""
    w = ffm.slice_width(n_end, n_slices)
    q = -(-k // 8)
    p = slices[:, :q * w * 4].reshape(n_slices, q, w, 4)
    return p.permute(1, 3, 0, 2).reshape(4 * q, n_slices * w)[:k // 2]


# cluster 8 and 16: the cluster kernels' slices; 0: stream slices of at
# most 16 columns
@pytest.mark.parametrize("cluster", [0, 8, 16])
@pytest.mark.parametrize("kind", ["tiled", "stacked"])
@pytest.mark.parametrize("stack", sorted(SLICE_STACKS))
def test_code_slices_round_trip(stack, kind, cluster):
    """Unpacking each (layer, slice) of the slice-major code copy and
    concatenating the slices gives back the pack's codes, zero past them."""
    table, shapes, packs, rows = _tables(SLICE_STACKS[stack], kind, cluster)
    codes = table.codes
    assert codes.dtype == torch.uint8
    assert table.cluster == cluster
    for l, (k, n) in enumerate(ffm.padded_shapes(shapes)):
        n = shapes[l][1]
        sb, off = int(rows["slice_bytes"][l]), int(rows["slice_off"][l])
        assert sb % 16 == 0 and off % 16 == 0
        assert sb == ffm.stack_slice_bytes(shapes, cluster)[l]
        assert rows["K"][l] == k
        n_end = ffm.output_width(n, l == len(shapes) - 1)
        ns = int(rows["n_slices"][l])
        assert ns == (cluster or -(-n_end // 16))
        assert rows["slice_w"][l] == ffm.slice_width(n_end, ns)
        got = _unslice(codes[off:off + ns * sb].reshape(ns, sb), k, n_end, ns)
        assert got.shape == (k // 2, ns * ffm.slice_width(n_end, ns))
        assert torch.equal(got[:, :n], packs[l][:k // 2, :n])
        assert not got[:, n:].any()
    assert codes.numel() == sum(int(ns) * int(b) for ns, b in
                                zip(rows["n_slices"], rows["slice_bytes"]))


@pytest.mark.parametrize("cluster", [0, 8, 16])
@pytest.mark.parametrize("stack", sorted(SLICE_STACKS))
def test_slices_cover_every_column_once(stack, cluster):
    """The slices' column ranges cover each layer's output columns -- the
    even pad included, nothing past it -- exactly once."""
    shapes = _shapes(SLICE_STACKS[stack])
    for l, (_, n) in enumerate(shapes):
        last = l == len(shapes) - 1
        n_end = ffm.output_width(n, last)
        assert n_end == (n if last else n + n % 2)
        ns = ffm.layer_slices(n_end, cluster)
        w = ffm.slice_width(n_end, ns)
        if not cluster:
            assert w <= 16
        seen = np.zeros(n_end, int)
        for rank in range(ns):
            c0 = rank * w
            seen[c0:min(c0 + w, n_end)] += 1
        np.testing.assert_array_equal(seen, 1)
        assert (w - 1) * ns < n_end <= w * ns


@pytest.mark.parametrize("k,n", [(34, 40), (40, 24), (24, 10), (128, 12),
                                 (512, 512), (42, 41), (26, 9), (2, 1)])
def test_chain_slices_round_trip(k, n):
    """The chain's slice-major copy of a (k/2, n) pack -- slices of at most
    16 columns, balanced -- unpacks to the pack, and the slices cover each
    column once; N = 10 and 12 (row strides a bulk copy cannot take) are
    one slice."""
    rng = np.random.default_rng(k * 1000 + n)
    packed = torch.from_numpy(
        rng.integers(0, 256, size=(k // 2, n)).astype(np.uint8))
    omega = torch.from_numpy(rng.normal(size=4).astype(np.float32))
    ops, built_before = fm.chain_operands(packed, omega, torch.device("cpu"))
    assert not built_before
    assert fm.chain_operands(packed, omega, torch.device("cpu")) == \
        (ops, True)
    ns, w, sb = ops.n_slices, ops.slice_w, ops.slice_bytes
    assert ns == -(-n // 16) and w <= 16 and (w - 1) * ns < n <= w * ns
    assert sb % 16 == 0 and ops.codes.numel() == ns * sb
    got = _unslice(ops.codes.reshape(ns, sb), k, n, ns)
    assert torch.equal(got[:, :n], packed) and not got[:, n:].any()
    seen = np.zeros(n, int)
    for s in range(ns):
        seen[s * w:min((s + 1) * w, n)] += 1
    np.testing.assert_array_equal(seen, 1)
    torch.testing.assert_close(ops.omega, omega, rtol=0, atol=0)
    ldx = fm.tile_stride(k)
    assert ldx >= k and ldx % 4 == 0 and (ldx // 4) % 2 == 1
    for rows in (1, 7, 32):
        assert fm.chain_smem_bytes(rows, k, sb) == \
            16 + 64 + 4 * rows * ldx + sb
    assert fm.forget_operands(packed) == 1
    assert fm.chain_operands(packed, omega, torch.device("cpu"))[1] is False


@pytest.mark.parametrize("kind", ["tiled", "stacked"])
@pytest.mark.parametrize("stack", sorted(SLICE_STACKS))
def test_fits_equal_the_layout(stack, kind):
    """The fits state the bytes the built layout implies: per CTA, the
    largest layer slice (batch_tiled), two of them (db) or every layer's
    (ws), plus the input buffers, descriptors, codebooks and mbarriers."""
    table, shapes, _, rows = _tables(SLICE_STACKS[stack], kind, ffm.CLUSTER)
    sb = [int(b) for b in rows["slice_bytes"]]
    n = len(sb)
    per_rank = table.codes.numel() // ffm.CLUSTER
    assert per_rank == sum(sb)
    ldx = ffm.input_stride(shapes)
    assert ldx % 4 == 0 and (ldx // 4) % 2 == 1
    assert ldx >= max(k for k, _ in ffm.padded_shapes(shapes))
    inputs = 2 * 4 * ldx
    assert ffm.ws_mlp_smem_bytes(shapes, rows=8) == \
        -(-8 * (n + 2) // 16) * 16 + (80 + 64) * n + 8 * inputs + per_rank
    assert ffm.ws_mlp_smem_bytes(shapes, rows=3) == \
        ffm.ws_mlp_smem_bytes(shapes, rows=8) - 5 * inputs
    assert ffm.ws_mlp_smem_bytes(shapes, rows=256) == \
        ffm.ws_mlp_smem_bytes(shapes, rows=8)
    for bm, db, want_db in ((32, False, False), (32, True, True),
                            (8, True, False), (64, False, False)):
        rows_t, got_db = ffm.tile_rows(bm, double_buffer=db)
        assert rows_t == min(bm, ffm.MAX_TILE_ROWS) and got_db == want_db
        assert ffm.fused_mlp_smem_bytes(shapes, bm, double_buffer=db) == (
            32 + (80 + 64) * n + rows_t * inputs
            + (2 if want_db else 1) * max(sb))


@pytest.mark.parametrize("stack", sorted(SLICE_STACKS))
def test_stream_fit_equals_the_layout(stack):
    """stream's fit states the bytes of its CTA's layout: one codebook,
    two mbarriers, a descriptor per layer, one row tile of input_stride
    fp32 (block_m rows, at most 32, at most the batch) and two buffers of
    the largest stream slice, as the built table cuts them."""
    table, shapes, _, rows = _tables(SLICE_STACKS[stack], "stacked", 0)
    n = len(shapes)
    region = max(int(b) for b in rows["slice_bytes"])
    ldx = ffm.input_stride(shapes)
    for m, bm, tile in ((1, 8, 1), (3, 8, 3), (256, 8, 8), (256, 64, 32),
                        (20, 16, 16)):
        assert ffm.stream_tile_rows(shapes, m, bm) == tile
        assert ffm.stream_mlp_smem_bytes(shapes, m, bm) == \
            64 + 16 + 80 * n + 4 * tile * ldx + 2 * region
    assert ffm.stream_mlp_smem_bytes(shapes, 256, 8) < \
        ffm.fused_mlp_smem_bytes(shapes, 8)


@pytest.mark.parametrize("budget", [26368, 60000, ffm.SMEM_BUDGET_BYTES])
@pytest.mark.parametrize("dims", [GSC, (8192, 64, 10), (33, 40, 24, 10)])
def test_stream_tile_follows_the_budget(dims, budget):
    """stream's tile is block_m rows, cut to the most rows whose CTA fits
    the budget: one row more would not fit, and a budget below one row's
    CTA fits none."""
    shapes = _shapes(dims)
    for m, bm in ((256, 8), (5, 8), (256, 32), (1, 1)):
        tile = ffm.stream_tile_rows(shapes, m, bm, budget)
        want = min(bm, m, ffm.MAX_TILE_ROWS)
        assert 0 <= tile <= want
        one_row = ffm.stream_mlp_smem_bytes(shapes, 1, 1)
        assert (tile >= 1) == (one_row <= budget) == \
            ffm.stream_mlp_fits(shapes, rows=m, block_m=bm,
                                smem_budget_bytes=budget)
        if tile:
            smem = ffm._stream_bytes(shapes, tile)
            assert smem <= budget
            if tile < want:
                assert smem + 4 * ffm.input_stride(shapes) > budget


@pytest.mark.parametrize("n", [10, 12, 40, 512])
@pytest.mark.parametrize("k", [34, 512, 1024, 1700, 2048, 8192, 8194, 65536])
def test_chain_tiling_fits_any_k(k, n):
    """The chain stages all of K when the x tile and the code slice fit a
    block's shared memory, else K chunks of a multiple of 64 rows whose
    code bytes are whole 16-byte units; the chunks cover the slice once
    and every CTA fits."""
    sl = slice_count(n)
    w, sb = slice_width(n, sl), slice_bytes(k, n, sl)
    for m in (1, 5, 8, 32, 256):
        rows, kc, chunk = fm.chain_tiling(m, k, w, sb)
        assert rows == min(m, fm.MAX_TILE_ROWS)
        assert fm.chain_smem_bytes(rows, kc, chunk) <= fm.SMEM_BUDGET_BYTES
        if fm.chain_smem_bytes(rows, k, sb) <= fm.SMEM_BUDGET_BYTES:
            assert (kc, chunk) == (k, sb)
            continue
        assert 0 < kc < k and kc % fm.K_CHUNK == 0
        assert chunk == kc // 2 * w and chunk % 16 == 0
        # one more K_CHUNK would not fit
        assert fm.chain_smem_bytes(rows, kc + fm.K_CHUNK,
                                   chunk + fm.K_CHUNK // 2 * w) > \
            fm.SMEM_BUDGET_BYTES
        chunks = -(-k // kc)
        tail = sb - (chunks - 1) * chunk
        assert 0 < tail <= chunk and tail % 16 == 0
        # the tail chunk's K rows lie in its bytes
        assert -(-(k - (chunks - 1) * kc) // 8) * 4 * w <= tail


@pytest.mark.parametrize("sched", SCHEDULES)
def test_budget_one_falls_back_to_chain(sched):
    pack = pack_from_numpy(_np_pack(STACKS["odd"], seed=4), device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(9, 33)).astype(np.float32))
    got = tops.fantastic4_mlp_fused(x, pack["layers"], schedule=sched,
                                    smem_budget_bytes=1)
    np.testing.assert_array_equal(
        got.numpy(), tops.fantastic4_mlp_chain(x, pack["layers"]).numpy())


def test_layer_table_layout():
    """The descriptor bytes the CUDA kernels read (f4::LayerDesc)."""
    pack = pack_from_numpy(_np_pack(STACKS["odd"], seed=5), device="cpu")
    layers = pack["layers"]
    table = ffm.tiled_layer_table(
        *[tuple(l[k] for l in layers) for k in
          ("packed", "omega", "alpha1", "bias", "alpha2")],
        shapes=tuple(l["shape"] for l in layers),
        activations=tuple(l["activation"] for l in layers),
        act_dtype="int8")
    rows = table.tensor.numpy().view(ffm.DESC_DTYPE)
    assert ffm.DESC_DTYPE.itemsize == 80 and len(rows) == 3
    np.testing.assert_array_equal(rows["K"], [34, 40, 24])
    np.testing.assert_array_equal(rows["N"], [40, 24, 10])
    np.testing.assert_array_equal(rows["quant"], [1, 1, 0])
    np.testing.assert_array_equal(rows["act"], [1, 1, 0])
    np.testing.assert_array_equal(rows["n_slices"], [8, 8, 8])
    np.testing.assert_array_equal(rows["slice_w"], [5, 3, 2])
    assert rows["packed"][1] == layers[1]["packed"].data_ptr()
    np.testing.assert_array_equal(rows["omega"][2],
                                  layers[2]["omega"].numpy())
    # the cluster kernels' code slices, layer after layer
    sb = ffm.stack_slice_bytes(tuple(l["shape"] for l in layers))
    np.testing.assert_array_equal(rows["slice_bytes"], sb)
    np.testing.assert_array_equal(rows["slice_off"],
                                  [0, 8 * sb[0], 8 * (sb[0] + sb[1])])
    assert table.codes.numel() == 8 * sum(sb) and table.cluster == 8
    # f4::LayerDesc's field offsets
    assert [ffm.DESC_DTYPE.fields[f][1] for f in
            ("packed", "n_slices", "slice_w", "omega", "scale", "K",
             "slice_bytes")] == [0, 24, 28, 32, 48, 52, 76]
    # stream's table: slices of at most 16 columns of each layer's
    # even-padded width (the last layer's true width)
    st = ffm.tiled_layer_table(
        *[tuple(l[k] for l in layers) for k in
          ("packed", "omega", "alpha1", "bias", "alpha2")],
        shapes=tuple(l["shape"] for l in layers),
        activations=tuple(l["activation"] for l in layers),
        act_dtype="int8", cluster=0)
    srows = st.tensor.numpy().view(ffm.DESC_DTYPE)
    np.testing.assert_array_equal(srows["n_slices"], [3, 2, 1])
    np.testing.assert_array_equal(srows["slice_w"], [14, 12, 10])
    assert st.n_slices == (3, 2, 1)


def test_unsupported_device_raises():
    x = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError):
        fm.fantastic4_matmul(x, torch.empty((2, 3), dtype=torch.uint8,
                                            device="meta"),
                             torch.empty(4, device="meta"))


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setenv(build.ENV_BUILD_DIR, str(tmp_path))
    path = build.library_path()
    assert path.parent == tmp_path
    assert build.source_hash() in path.name
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


FAKE_NVCC = r'''#!{python}
import json, os, sys
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(json.dumps(args) + "\n")
if any(a.endswith("ecl_quant.cu") for a in args) and os.environ.get("FAKE_NVCC_FAIL"):
    sys.stderr.write("error: refused\n")
    sys.exit(2)
open(args[args.index("-o") + 1], "w").close()
'''


@pytest.mark.parametrize("fail", [False, True])
def test_build_compiles_each_source_then_links(tmp_path, monkeypatch, fail):
    """One compile per source (every source in SOURCES), one link into the
    hashed library; a failing compile raises with its output and leaves no
    library behind."""
    import json
    import sys

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.replace("{python}", sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "log.jsonl"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    if fail:
        monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    monkeypatch.setenv(build.ENV_BUILD_DIR, str(tmp_path / "out"))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    assert "ecl_quant.cu" in build.SOURCES
    if fail:
        with pytest.raises(RuntimeError, match="refused"):
            build.build()
        assert not build.library_path().exists()
        return
    assert build.build() == build.library_path()
    assert build.library_path().exists()
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    compiles = [c for c in calls if "-c" in c]
    assert sorted(c[-1].rsplit("/", 1)[-1] for c in compiles) == \
        sorted(build.SOURCES)
    assert all("-shared" not in c for c in compiles)
    (link,) = [c for c in calls if "-c" not in c]
    assert "-shared" in link and len(link) == 3 + len(build.SOURCES)
