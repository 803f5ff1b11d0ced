"""The reference against the program's plain CPU path (its kernels' plain
versions, float32) at the program's tiny widths, on the same weights."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import traffic, weights
from perfbench.reference import foundation as ref_ocr
from perfbench.reference import layout as ref_layout
from perfbench.systems.layout import final_class
from perfbench.tests import tiny

SEED = 2**31 + 3


@pytest.fixture(scope="module")
def port_env(monkeypatch_module):
    for k in ("RECOGNITION_MODEL_CHECKPOINT", "LAYOUT_MODEL_CHECKPOINT", "DETECTOR_MODEL_CHECKPOINT"):
        monkeypatch_module.setenv(k, "/dev/null")
    monkeypatch_module.setenv("ALLOW_RANDOM_WEIGHTS", "true")


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def page():
    mix = dict(traffic.load("lines40"), page_pool=1)
    return traffic.page_pool(mix, SEED)[0]


def test_recognition_matches_the_program(port_env, page):
    from surya_tpu_torch.models.qwen_encoder import plan_layout
    from surya_tpu_torch.recognition.loader import load_recognition_model

    model, config, processor = load_recognition_model(None, tiny=True, device="cpu")
    cfg = tiny.OCR["model"]
    W = weights.make(ref_ocr.param_shapes(cfg), SEED, "cpu", torch.float32)
    model.load_state_dict(W, strict=True)
    x0, y0, x1, y1 = page.lines[0]
    poly = [[x0 - 4, y0 - 4], [x1 + 4, y0 - 4], [x1 + 4, y1 + 4], [x0 - 4, y1 + 4]]
    crop = ref_ocr.slice_polygon(np.asarray(page.image), poly)
    img = processor.scale_to_fit(crop, (1024, 256))
    assert np.array_equal(img, ref_ocr.scale_to_fit(crop, (1024, 256)))
    raw, grid = processor.tile_image(img)
    plan = plan_layout([grid], config.encoder, -(-raw.shape[0] // 128) * 128)
    patches = np.zeros((plan.cap, raw.shape[1]), np.uint8)
    patches[: raw.shape[0]] = raw
    with torch.no_grad():
        x = processor.normalize_patch_rows(torch.from_numpy(patches), torch.float32)
        args = tuple(torch.from_numpy(np.asarray(a)) for a in plan.device_args)
        port_tokens = model.encode_images(x, args, torch.from_numpy(plan.llm_h_idx), torch.from_numpy(plan.llm_w_idx),
                                          plan.kv_range, plan.win_range, use_kernels=False)[: plan.n_llm_tokens]
        rx, rgrid = ref_ocr.patches(img, 14, 2)
        assert rgrid == grid
        ref_tokens = ref_ocr.encode(W, cfg, rx, rgrid)
        np.testing.assert_allclose(ref_tokens.numpy(), port_tokens.numpy(), rtol=1e-4, atol=1e-4)

        prompt = ref_ocr.prompt_ids(cfg, ref_tokens.shape[0])
        assert prompt == processor.build_prompt_ids("ocr_with_boxes", ref_tokens.shape[0], "", True)
        served = [5, 17, 300, 9]
        ref_logits = ref_ocr.logits(W, cfg, ref_tokens, prompt, served)
        for j in range(len(served)):  # the program's prefill over the prompt and the first j tokens
            ids = torch.tensor([prompt + served[:j]])
            gather = torch.full_like(ids, -1)
            gather[0, : ref_tokens.shape[0]] = torch.arange(ref_tokens.shape[0])
            embeds = model.embed_prompt_tokens(ids, gather, port_tokens)
            _, _, last = model.decoder.prefill(embeds, torch.tensor([ids.shape[1]]), use_kernels=False)
            port_logits = last @ model.token_embed.weight.T + model.lm_head_bias
            np.testing.assert_allclose(ref_logits[j].numpy(), port_logits[0].numpy(), rtol=1e-4, atol=1e-4)


def test_layout_matches_the_program(port_env, page):
    from surya_tpu_torch.layout.loader import layout_config
    from surya_tpu_torch.layout import LayoutPredictor

    cfg = tiny.LAYOUT["model"]
    pinned = dataclasses.replace(layout_config(True), eos_token_id=-1, pad_token_id=-1, max_boxes=6)
    lay = LayoutPredictor(None, True, device="cpu", config=pinned)
    W = weights.make(ref_layout.param_shapes(cfg), SEED, "cpu", torch.float32)
    lay.model.load_state_dict(W, strict=True)
    tiles = ref_layout.tiles(page.image, cfg)
    assert len(tiles) == 2
    with torch.no_grad():
        boxes, logits, valid = lay.model.generate(torch.from_numpy(np.stack(tiles)))
        assert bool(valid.all())
        for t, tile in enumerate(tiles):
            feeds = torch.cat([torch.full((1, 7), 1.0), boxes[t, :-1].to(torch.int32).float()]).long()
            lg, box = ref_layout.decode(W, cfg, ref_layout.encode(W, cfg, tile, "cpu"), feeds)
            np.testing.assert_allclose(box.numpy(), boxes[t, :, :6].numpy(), rtol=1e-4, atol=2e-3)
            # the served class, the header/footer rule applied as the program applies it
            assert torch.equal(final_class(cfg, lg, box), boxes[t, :, 6].long())
