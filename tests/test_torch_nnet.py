"""mousiki_tpu_torch.models.nnet against mousiki_tpu.models.nnet: the
neural primitives (linear with and without the diag shortcut, dense under
every activation, gru, glu, conv1d_step with and without history) on the
same seeded inputs and weights, and the libopus weight-blob loaders on the
same blob bytes (float, dense int8 and sparse 8x4 weights; densified
matrices equal exactly), FARGAN and RDOVAE included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mousiki_tpu.models import dred as jax_dred
from mousiki_tpu.models import fargan as jax_fargan
from mousiki_tpu.models import nnet as jax_nnet
from mousiki_tpu_torch import convert
from mousiki_tpu_torch.models import dred, fargan, nnet
from torch_threads import one_torch_thread  # noqa: F401
from torch_threads import seeded_jax_model

TOL = 1e-5   # tests/test_models.py:54


def _layer(rng, nin, nout, bias=True, diag=False):
    w = (rng.standard_normal((nout, nin)) * 0.3).astype(np.float32)
    b = rng.standard_normal(nout).astype(np.float32) if bias else None
    d = (rng.standard_normal(3 * nin).astype(np.float32) * 0.2
         if diag else None)
    ref = jax_nnet.Linear(jnp.asarray(w), None if b is None
                          else jnp.asarray(b),
                          None if d is None else jnp.asarray(d))
    return ref, convert.linear_from_numpy(ref, "cpu")


def _pair(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, tol=TOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("bias,diag", [(True, False), (False, False),
                                       (True, True)])
def test_linear_matches_jax(bias, diag):
    rng = np.random.default_rng(0)
    n = 12
    ref, port = _layer(rng, n, 3 * n if diag else 7, bias, diag)
    xj, xt = _pair(rng, 4, n)
    _close(nnet.linear(port, xt), jax_nnet.linear(ref, xj))


@pytest.mark.parametrize("act", range(6))
def test_dense_activation_matches_jax(act):
    rng = np.random.default_rng(1 + act)
    ref, port = _layer(rng, 9, 5)
    xj, xt = _pair(rng, 3, 9)
    _close(nnet.dense(port, xt, act), jax_nnet.dense(ref, xj, act))


def test_gru_and_glu_match_jax():
    rng = np.random.default_rng(7)
    n, m = 16, 24
    ri, pi = _layer(rng, m, 3 * n)
    rr, pr = _layer(rng, n, 3 * n, diag=True)     # diag on the recurrence
    xj, xt = _pair(rng, 5, m)
    hj, ht = _pair(rng, 5, n)
    _close(nnet.gru(pi, pr, ht, xt), jax_nnet.gru(ri, rr, hj, xj))
    rg, pg = _layer(rng, m, m)
    _close(nnet.glu(pg, xt), jax_nnet.glu(rg, xj))


@pytest.mark.parametrize("hist", [0, 2])
def test_conv1d_step_matches_jax(hist):
    """hist = 0: the kernel covers one frame of inputs (FARGAN's fwc0, no
    memory); hist = 2: two frames of history, threaded over 4 steps."""
    rng = np.random.default_rng(11)
    n_in, n_out, S = 6, 5, 3
    ref, port = _layer(rng, (hist + 1) * n_in, n_out, diag=False)
    mem_j = jnp.zeros((S, hist * n_in))
    mem_t = torch.zeros((S, hist * n_in))
    for _ in range(4):
        xj, xt = _pair(rng, S, n_in)
        yj, mem_j = jax_nnet.conv1d_step(ref, mem_j, xj, jax_nnet.ACTIVATION_TANH)
        yt, mem_t = nnet.conv1d_step(port, mem_t, xt, nnet.ACTIVATION_TANH)
        _close(yt, yj)
        _close(mem_t, mem_j)
    assert mem_t.shape == (S, hist * n_in)


def _blob_case(kind, rng, nin, nout):
    """Blob arrays of one layer in the storage of `kind`."""
    bias = rng.standard_normal(nout).astype("<f4").tobytes()
    if kind == "float":
        w = rng.standard_normal(nin * nout).astype("<f4")
        return {"l_weights_float": w.tobytes(), "l_bias": bias,
                "l_diag": rng.standard_normal(3 * nin).astype(
                    "<f4").tobytes()}
    # 8-row bands, 4-column blocks
    if kind == "int8_dense":
        n = ((nout + 7) // 8) * 8 * ((nin + 3) // 4) * 4
        return {"l_weights_int8": rng.integers(-127, 128, n,
                                               np.int8).tobytes(),
                "l_scale": rng.uniform(1e-3, 1e-2, nout).astype(
                    "<f4").tobytes(), "l_bias": bias}
    idx = []
    for _ in range(nout // 8):
        cols = sorted(rng.choice(np.arange(0, nin, 4), 2, replace=False))
        idx += [2] + [int(c) for c in cols]
    idx = np.asarray(idx, "<i4")
    nblk = len(idx) - nout // 8
    if kind == "float_sparse":
        return {"l_weights_float": rng.standard_normal(32 * nblk).astype(
                    "<f4").tobytes(), "l_weights_idx": idx.tobytes(),
                "l_bias": bias}
    return {"l_weights_int8": rng.integers(-127, 128, 32 * nblk,
                                           np.int8).tobytes(),
            "l_weights_idx": idx.tobytes(),
            "l_scale": rng.uniform(1e-3, 1e-2, nout).astype(
                "<f4").tobytes(), "l_bias": bias}


@pytest.mark.parametrize("kind", ["float", "float_sparse", "int8_dense",
                                  "int8_sparse"])
def test_load_linear_matches_reference(kind):
    """tests/test_weight_blob.py:39,67 cover the int8 layouts against the
    reference's own sgemv; here the port's loader equals the JAX
    package's on the same bytes, matrix for matrix."""
    rng = np.random.default_rng(["float", "float_sparse", "int8_dense",
                                 "int8_sparse"].index(kind))
    # the float case carries a diag shortcut, which needs out == 3 * in
    nin, nout = (8, 24) if kind == "float" else (20, 16)
    arrays = _blob_case(kind, rng, nin, nout)
    want = jax_nnet.load_linear(arrays, "l", nin, nout)
    got = nnet.load_linear(arrays, "l", nin, nout, device="cpu")
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.w))
    np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want.b))
    if want.diag is None:
        assert got.diag is None
    else:
        np.testing.assert_array_equal(got.diag.numpy(), np.asarray(want.diag))
    auto_w = jax_nnet.load_linear_auto(arrays, "l")
    auto_g = nnet.load_linear_auto(arrays, "l", device="cpu")
    np.testing.assert_array_equal(auto_g.weight.numpy(),
                                  np.asarray(auto_w.w))
    xj, xt = _pair(rng, 3, nin)
    yj = jax_nnet.linear(want, xj)
    # the int8 layers fold x127 into the weights: outputs reach hundreds
    _close(nnet.linear(got, xt), yj, TOL * max(1.0, float(np.abs(yj).max())))


def _linear_blob(prefix, lin) -> dict:
    """A reference Linear in the blob's float col-major convention
    (tests/test_weight_blob.py _blob_arrays_from_linear)."""
    w = np.asarray(lin.w, np.float32)
    out = {prefix + "_weights_float": w.T.astype("<f4").tobytes()}
    if lin.b is not None:
        out[prefix + "_bias"] = np.asarray(lin.b, np.float32).astype(
            "<f4").tobytes()
    return out


_FARGAN_NAMES = {
    "cond_net_fdense1": "cond_fdense1", "cond_net_fconv1": "cond_fconv1",
    "cond_net_fdense2": "cond_fdense2",
    "sig_net_cond_gain_dense": "cond_gain_dense",
    "sig_net_fwc0_conv": "fwc0_conv", "sig_net_fwc0_glu_gate": "fwc0_glu",
    "sig_net_gru1_input": "gru1_in", "sig_net_gru1_recurrent": "gru1_rec",
    "sig_net_gru1_glu_gate": "gru1_glu", "sig_net_gru2_input": "gru2_in",
    "sig_net_gru2_recurrent": "gru2_rec", "sig_net_gru2_glu_gate": "gru2_glu",
    "sig_net_gru3_input": "gru3_in", "sig_net_gru3_recurrent": "gru3_rec",
    "sig_net_gru3_glu_gate": "gru3_glu", "sig_net_skip_dense": "skip_dense",
    "sig_net_skip_glu_gate": "skip_glu",
    "sig_net_sig_dense_out": "sig_dense_out",
    "sig_net_gain_dense_out": "gain_dense_out"}


def test_fargan_from_blob_matches_reference():
    """tests/test_weight_blob.py:97 on the port: the same blob bytes load
    into equal matrices and the same frame."""
    m = seeded_jax_model(jax_fargan.random_model, 0, lambda s: 0.08)
    arrays = {}
    for prefix, field in _FARGAN_NAMES.items():
        arrays.update(_linear_blob(prefix, getattr(m, field)))
    arrays.update(_linear_blob("cond_net_pembed", jax_nnet.Linear(
        jnp.asarray(np.asarray(m.cond_pembed).T),
        jnp.zeros(m.cond_pembed.shape[1]), None)))
    parsed = nnet.parse_weight_blob(nnet.write_weight_blob(arrays))
    want = jax_fargan.from_blob(parsed)
    got = fargan.from_blob(parsed, device="cpu")
    np.testing.assert_array_equal(got.cond_pembed.numpy(),
                                  np.asarray(want.cond_pembed))
    for field in fargan.LAYERS:
        np.testing.assert_array_equal(getattr(got, field).weight.numpy(),
                                      np.asarray(getattr(want, field).w),
                                      err_msg=field)
    feats = np.random.default_rng(3).standard_normal((2, 20)).astype(
        np.float32) * 0.2
    per = np.asarray([80, 120], np.int32)
    yj, _ = jax_fargan.synthesize_frame(want, jax_fargan.init_state(want, 2),
                                        jnp.asarray(feats), jnp.asarray(per))
    yt, _ = fargan.synthesize_frame(got, fargan.init_state(got, 2),
                                    torch.from_numpy(feats),
                                    torch.from_numpy(per))
    _close(yt, yj)


def _rdovae_layer_pairs(ref, port):
    """(reference Linear, port Linear) for every layer of an RDOVAE
    encoder or decoder."""
    names = ("dense1", "zdense", "gdense1", "gdense2", "hidden_init",
             "gru_init", "output")
    pairs = [(getattr(ref, n), getattr(port, n)) for n in names
             if hasattr(ref, n)]
    for k in range(5):
        pairs += list(zip(ref.grus[k], port.grus[k]))
        pairs.append((ref.convs[k], port.convs[k]))
        if hasattr(ref, "glus"):
            pairs.append((ref.glus[k], port.glus[k]))
    return pairs


def test_rdovae_from_blob_matches_reference():
    """tests/test_weight_blob.py:152 on the port."""
    enc = seeded_jax_model(jax_dred.random_enc, 1,
                           lambda s: 0.3 / np.sqrt(s[1]))
    dec = seeded_jax_model(jax_dred.random_dec, 2,
                           lambda s: 0.3 / np.sqrt(s[1]))
    arrays = {}
    for name in ("dense1", "zdense"):
        arrays.update(_linear_blob(f"enc_{name}", getattr(enc, name)))
    for name in ("gdense1", "gdense2"):
        arrays.update(_linear_blob(name, getattr(enc, name)))
    for name in ("hidden_init", "gru_init", "dense1", "output"):
        arrays.update(_linear_blob(f"dec_{name}", getattr(dec, name)))
    for k in range(5):
        for side, m in (("enc", enc), ("dec", dec)):
            gi, gr = m.grus[k]
            arrays.update(_linear_blob(f"{side}_gru{k + 1}_input", gi))
            arrays.update(_linear_blob(f"{side}_gru{k + 1}_recurrent", gr))
            arrays.update(_linear_blob(f"{side}_conv{k + 1}", m.convs[k]))
        arrays.update(_linear_blob(f"dec_glu{k + 1}", dec.glus[k]))
    parsed = nnet.parse_weight_blob(nnet.write_weight_blob(arrays))
    enc_w, dec_w = jax_dred.enc_from_blob(parsed), jax_dred.dec_from_blob(parsed)
    enc_g = dred.enc_from_blob(parsed, device="cpu")
    dec_g = dred.dec_from_blob(parsed, device="cpu")
    for want, got in ((enc_w, enc_g), (dec_w, dec_g)):
        for ref, port in _rdovae_layer_pairs(want, got):
            np.testing.assert_array_equal(port.weight.numpy(),
                                          np.asarray(ref.w))
            np.testing.assert_array_equal(port.bias.numpy(),
                                          np.asarray(ref.b))
    rng = np.random.default_rng(5)
    feats = (rng.standard_normal((1, 40)) * 0.3).astype(np.float32)
    lj, sj, _ = jax_dred.encode_dframe(enc_w, jax_dred.enc_init_state(enc_w),
                                       jnp.asarray(feats[0]))
    lt, st, _ = dred.encode_dframe(enc_g, dred.enc_init_state(enc_g, 1),
                                   torch.from_numpy(feats))
    _close(lt[0], lj)
    _close(st[0], sj)
    lat = rng.standard_normal((1, 24)).astype(np.float32)
    st24 = np.zeros((1, 24), np.float32)
    oj, _ = jax_dred.decode_qframe(dec_w, jax_dred.dec_init_state(
        dec_w, st24[0]), jnp.asarray(lat[0]))
    ot, _ = dred.decode_qframe(dec_g, dred.dec_init_state(
        dec_g, torch.from_numpy(st24)), torch.from_numpy(lat))
    _close(ot[0], oj)
