"""nerf_hugs_torch's SAM (hugs/sam/modeling.py, weights.py) against the
JAX package's flax SAM, module by module, and the weights carried across.

Every module runs on the same numpy inputs with the same weights: a state
dict in the official segment-anything schema filled at random
(tests/sam_official_schema.py), converted into flax variables by JAX's
weights.convert_state_dict and carried into the port by
models/from_jax.py::sam_state_dict. Tolerance: 1e-5 of each output's
largest entry, float32, at the JAX tests' toy size (vit_t, image_size 64,
window_size 2).
"""

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (pins torch's threads)
from nerf_hugs_torch.hugs.sam import modeling as tm
from nerf_hugs_torch.hugs.sam import predictor as tpred
from nerf_hugs_torch.hugs.sam import weights as tw
from nerf_hugs_torch.models.from_jax import sam_state_dict
from nerf_hugs_tpu.hugs.sam import modeling as jm
from nerf_hugs_tpu.hugs.sam import weights as jw
from sam_official_schema import make_official_sam_state_dict

TOY = dict(image_size=64, window_size=2)
TOL = 1e-5
UPSCALING = ("mask_decoder.output_upscaling.0.weight",
             "mask_decoder.output_upscaling.3.weight")


@pytest.fixture(scope="module")
def toy():
    """(config, flax params, the port's Sam with the same weights)."""
    config = jm.make_sam_config("vit_t", **TOY)
    sd = make_official_sam_state_dict(config, fill="random", seed=1)
    variables = jw.convert_state_dict(sd, config)
    sam = tm.Sam(tm.make_sam_config("vit_t", **TOY))
    tw.load_state_dict(sam, sam_state_dict(variables))
    return config, variables["params"], sam.eval()


def close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err,
                                                    float(np.abs(want).max()))


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def nchw(a):
    return t(np.asarray(a).transpose(0, 3, 1, 2))


def test_config_and_vit_table_match_jax():
    assert tm.VIT_CONFIGS == jm.VIT_CONFIGS
    for name in ("default", "vit_b", "vit_l", "vit_h", "vit_t"):
        assert (tm.make_sam_config(name, **TOY).__dict__
                == jm.make_sam_config(name, **TOY).__dict__)
    assert tm.SamConfig().__dict__ == jm.SamConfig().__dict__


def test_layernorm2d(toy):
    _, p, sam = toy
    x = rand(2, 3, 5, 256, seed=2, scale=3.0) + 1.0
    want = jm.LayerNorm2d().apply({"params": p["image_encoder"]["neck_ln1"]},
                                  x)
    close(sam.image_encoder.neck[1](nchw(x)).permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("q,k,length", [(4, 4, 7), (3, 3, 5), (7, 7, 5),
                                        (4, 8, 15), (6, 3, 5)],
                         ids=["matched", "matched-3", "upsampled",
                              "q<k", "q>k-resized"])
def test_get_rel_pos(q, k, length):
    rel = rand(length, 8, seed=q + k)
    close(tm._get_rel_pos(q, k, t(rel)), jm._get_rel_pos(q, k, rel))


def test_attention_with_rel_pos(toy):
    _, p, sam = toy
    x = rand(3, 2, 2, 64, seed=3)
    attn = jm.Attention(2, input_size=(2, 2))
    want = attn.apply({"params": p["image_encoder"]["block_0"]["attn"]}, x)
    close(sam.image_encoder.blocks[0].attn(t(x)), want)
    # The global block's tables span the whole 4 x 4 grid.
    x = rand(1, 4, 4, 64, seed=4)
    want = jm.Attention(2, input_size=(4, 4)).apply(
        {"params": p["image_encoder"]["block_1"]["attn"]}, x)
    close(sam.image_encoder.blocks[1].attn(t(x)), want)


@pytest.mark.parametrize("shape,window", [((2, 5, 7, 8), 3),
                                          ((1, 4, 4, 6), 2),
                                          ((2, 14, 9, 4), 14)])
def test_window_partition(shape, window):
    x = rand(*shape, seed=5)
    want, want_pad = jm.window_partition(x, window)
    got, got_pad = tm.window_partition(t(x), window)
    assert got_pad == want_pad
    close(got, want)
    back = tm.window_unpartition(got, window, got_pad, shape[1:3])
    close(back, jm.window_unpartition(want, window, want_pad, shape[1:3]))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("index", [0, 1], ids=["windowed", "global"])
def test_block(toy, index):
    config, p, sam = toy
    x = rand(2, 4, 4, 64, seed=6)
    window = 0 if index in config.encoder_global_attn_indexes else 2
    want = jm.Block(2, window, (4, 4)).apply(
        {"params": p["image_encoder"][f"block_{index}"]}, x)
    close(sam.image_encoder.blocks[index](t(x)), want)


def test_image_encoder(toy):
    config, p, sam = toy
    x = rand(2, 64, 64, 3, seed=7)
    want = jm.ImageEncoderViT(config).apply(
        {"params": p["image_encoder"]}, x)
    close(sam.image_encoder(nchw(x)).permute(0, 2, 3, 1), want)


def prompts(n=5, per=3, seed=8):
    rs = np.random.RandomState(seed)
    coords = (rs.rand(n, per, 2) * 64).astype(np.float32)
    labels = rs.choice([-1.0, 0.0, 1.0], (n, per)).astype(np.float32)
    labels[0] = [-1, 0, 1]
    return coords, labels


def test_prompt_encoder(toy):
    config, p, sam = toy
    coords, labels = prompts()
    enc = jm.PromptEncoder(config)
    sparse, dense = enc.apply({"params": p["prompt_encoder"]}, coords,
                              labels)
    got_sparse, got_dense = sam.prompt_encoder(t(coords), t(labels))
    close(got_sparse, sparse)
    close(got_dense.permute(0, 2, 3, 1), dense)
    pe = enc.apply({"params": p["prompt_encoder"]},
                   method=jm.PromptEncoder.get_dense_pe)
    close(sam.prompt_encoder.get_dense_pe()[0].permute(1, 2, 0), pe)


@pytest.mark.parametrize("name,rate", [("self_attn", 1),
                                       ("cross_attn_token_to_image", 2)])
def test_down_attention(toy, name, rate):
    _, p, sam = toy
    q, k, v = rand(3, 7, 256, seed=9), rand(3, 16, 256, seed=10), \
        rand(3, 16, 256, seed=11)
    want = jm._DownAttention(8, rate).apply(
        {"params": p["mask_decoder"]["transformer"]["layer_1"][name]},
        q, k, v)
    got = getattr(sam.mask_decoder.transformer.layers[1], name)(
        t(q), t(k), t(v))
    close(got, want)


def decoder_inputs(seed=12):
    emb = rand(1, 4, 4, 256, seed=seed)
    pe = rand(4, 4, 256, seed=seed + 1)
    sparse = rand(3, 4, 256, seed=seed + 2)
    return emb, pe, sparse


def test_two_way_transformer(toy):
    _, p, sam = toy
    emb, pe, sparse = decoder_inputs()
    emb = np.broadcast_to(emb, (3,) + emb.shape[1:])
    want_q, want_k = jm.TwoWayTransformer().apply(
        {"params": p["mask_decoder"]["transformer"]}, emb, pe[None], sparse)
    got_q, got_k = sam.mask_decoder.transformer(
        nchw(emb), nchw(pe[None]), t(sparse))
    close(got_q, want_q)
    close(got_k, want_k)


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder(toy, multimask):
    config, p, sam = toy
    emb, pe, sparse = decoder_inputs(13)
    dense = rand(3, 4, 4, 256, seed=16)
    want_m, want_i = jm.MaskDecoder(config).apply(
        {"params": p["mask_decoder"]}, np.broadcast_to(emb, (3, 4, 4, 256)),
        pe[None], sparse, dense, multimask)
    got_m, got_i = sam.mask_decoder(nchw(emb), nchw(pe[None]), t(sparse),
                                    nchw(dense), multimask)
    assert got_m.shape == (3, 3 if multimask else 1, 16, 16)
    close(got_m, want_m)
    close(got_i, want_i)


def test_sam_predict_masks(toy):
    config, p, sam = toy
    x = rand(1, 64, 64, 3, seed=17)
    coords, labels = prompts(4, 3, 18)
    model = jm.Sam(config)
    emb = model.apply({"params": p}, x, method=jm.Sam.encode_image)
    want_m, want_i = model.apply(
        {"params": p}, np.broadcast_to(emb, (4,) + emb.shape[1:]), coords,
        labels, method=jm.Sam.predict_masks)
    with torch.no_grad():
        got_emb = sam.encode_image(nchw(x))
        got_m, got_i = sam.predict_masks(got_emb, t(coords), t(labels))
    close(got_emb.permute(0, 2, 3, 1), emb)
    close(got_m, want_m)
    close(got_i, want_i)


# -- weights ----------------------------------------------------------------


def test_official_round_trip_flips_only_the_upscaling_convolutions():
    """official -> JAX's convert_state_dict -> sam_state_dict: every key
    back as it was, except the two ConvTranspose kernels, which come back
    flipped in both spatial axes: JAX's _convT (weights.py:39) does not
    flip them, so its model mirrors each 2x2 cell of the upscaling."""
    config = jm.make_sam_config("vit_t", **TOY)
    sd = make_official_sam_state_dict(config, fill="random", seed=2)
    back = sam_state_dict(jw.convert_state_dict(sd, config))
    official = {k: v for k, v in sd.items()
                if not k.startswith(tw.INTENTIONALLY_UNUSED_PREFIXES)}
    assert set(back) == set(official)
    for k, want in official.items():
        got = back[k].numpy()
        if k in UPSCALING:
            assert not np.array_equal(got, want), k
            np.testing.assert_array_equal(got, want[:, :, ::-1, ::-1])
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_conv_transpose_flip_matches_flax(toy):
    """The flip makes torch's ConvTranspose2d compute flax's ConvTranspose
    on the same flax kernel; the kernel taken as it is would not."""
    import flax.linen as nn
    _, p, sam = toy
    kernel = np.asarray(p["mask_decoder"]["upscale_conv1"]["kernel"])
    x = rand(2, 4, 4, 256, seed=19)
    want = nn.ConvTranspose(64, (2, 2), strides=(2, 2), use_bias=False
                            ).apply({"params": {"kernel": kernel}}, x)
    conv = torch.nn.ConvTranspose2d(256, 64, 2, stride=2, bias=False)
    with torch.no_grad():
        conv.weight.copy_(sam.mask_decoder.output_upscaling[0].weight)
        close(conv(nchw(x)).permute(0, 2, 3, 1), want)
        conv.weight.copy_(t(kernel.transpose(2, 3, 0, 1)))
        err = (conv(nchw(x)).permute(0, 2, 3, 1).numpy() - want)
    assert np.abs(err).max() > 1e-2


def test_strict_loading_refuses_stray_and_missing_keys(tmp_path):
    config = tm.make_sam_config("vit_t", **TOY)
    sd = {k: torch.from_numpy(v) for k, v in make_official_sam_state_dict(
        config, fill="random", seed=3).items()}
    path = tmp_path / "sam_vit_t.pth"
    torch.save(sd, path)
    loaded = tw.load_torch_checkpoint(str(path))
    assert not any(k.startswith("prompt_encoder.mask_downscaling")
                   for k in loaded)
    # The checkpoint's tables set the input size and the window.
    sam = tpred.build_sam("vit_t", str(path))
    assert (sam.config.image_size, sam.config.window_size) == (64, 2)
    for k, v in sam.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    official = tm.make_sam_config("vit_h")
    assert tw.checkpoint_sizes({
        "image_encoder.pos_embed": torch.zeros(1, 64, 64, 1),
        "image_encoder.blocks.0.attn.rel_pos_h": torch.zeros(27, 1)},
        official) == {"image_size": 1024, "window_size": 14}
    with pytest.raises(ValueError, match="bogus"):
        tw.load_state_dict(tm.Sam(config), {
            **loaded, "image_encoder.bogus.weight": torch.zeros(1)})
    missing = dict(loaded)
    del missing["mask_decoder.iou_token.weight"]
    with pytest.raises(ValueError, match="iou_token"):
        tw.load_state_dict(tm.Sam(config), missing)
    wrong = dict(loaded, **{"image_encoder.pos_embed": torch.zeros(1, 2, 2,
                                                                    64)})
    with pytest.raises(ValueError, match="pos_embed"):
        tw.load_state_dict(tm.Sam(config), wrong)


def test_sam_state_dict_refuses_unknown_leaves(toy):
    _, p, _ = toy
    bad = {**p, "mask_decoder": {**p["mask_decoder"],
                                 "extra": {"gamma": np.zeros(3)}}}
    with pytest.raises(ValueError, match="extra/gamma"):
        sam_state_dict({"params": bad})


def test_seeded_init_keeps_flax_zero_leaves():
    """build_sam without a checkpoint: seeded, repeatable, the leaves a flax
    init leaves at zero or one kept so, the rest drawn with the spread of
    flax's initializers."""
    a = tpred.build_sam("vit_t", rng_seed=4, **TOY).state_dict()
    b = tpred.build_sam("vit_t", rng_seed=4, **TOY).state_dict()
    c = tpred.build_sam("vit_t", rng_seed=5, **TOY).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    zero = [k for k in a if k.endswith(("bias", "pos_embed", "rel_pos_h",
                                        "rel_pos_w"))]
    assert zero and all(not a[k].any() for k in zero)
    norms = [k for k in a if ".norm" in k or "neck.1" in k or "neck.3" in k
             or "output_upscaling.1" in k]
    assert all((a[k] == 1).all() for k in norms if k.endswith("weight"))
    qkv = a["image_encoder.blocks.0.attn.qkv.weight"]
    assert abs(float(qkv.std()) * 64 ** 0.5 - 1) < 0.1
    assert float(qkv.abs().max()) <= 2 / 64 ** 0.5 / .87962566 + 1e-6
    emb = a["mask_decoder.mask_tokens.weight"]
    assert 0.7 < float(emb.std()) < 1.3
    assert not torch.equal(qkv, c["image_encoder.blocks.0.attn.qkv.weight"])
