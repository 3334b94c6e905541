"""The port's image decode (``models/image.py``), ViT encoder
(``models/vision.py``), encode worker (``components/encode.py``) and the
launcher's in-process encoder against the JAX package and PIL.

- ``decode_image`` equals PIL's ``Image.open(...).convert("RGB").resize``
  byte for byte: on ``tests/test_multimodal.py``'s ``png_bytes``, on
  PIL-written grey, palette, RGBA and grey-alpha PNGs, on PNGs whose rows
  cycle through the five filter types (every colour type), and on up-
  and down-scales (48 → 64, 640 × 480 → 448, non-square, 1-pixel rows).
  JPEG, GIF, interlaced PNGs and PNGs of bit depth 4 or 16, a bad CRC and
  bytes that are no image are refused by name.
- ``encode_patches`` with JAX's weights carried across is within
  1e-5·max|ref| + 1e-6 of JAX's (f32: the same products summed in other
  orders, a tanh GELU and a softmax); so is ``VisionEncoder.encode`` of
  the same PNGs.
- The in-process encoder behind the HTTP service (what ``launch.run
  --mm-image-tokens`` builds) gives JAX's greedy chat answers when both
  packages' LM and ViT weights are the same (f32 tiny-llama).
- The encode worker and the frontend run end to end as processes on the
  CPU: a PNG chat answers, the same image twice alike, another image
  otherwise, and a JPEG answers 400 with the worker's ``bad image:`` text.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import io
import json
import struct
import threading
import time
import urllib.error
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dynamo_tpu.models import vision as jv
from dynamo_tpu_torch.chaos.harness import Proc, free_port, http_json
from dynamo_tpu_torch.models import image as timg
from dynamo_tpu_torch.models import vision as tv
from tests.test_multimodal import png_bytes

RNG = np.random.default_rng(0)


def pil(data: bytes, size: int) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB").resize((size, size)))


def pil_png(arr: np.ndarray, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    img = Image.fromarray(arr, mode=mode) if mode != "P" else Image.fromarray(arr, mode="P")
    if mode == "P":
        img.putpalette(kw.pop("palette"))
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _images() -> dict[str, bytes]:
    out = {f"png_bytes{s}": png_bytes(s) for s in (1, 2, 5)}
    out["pil_grey"] = pil_png(RNG.integers(0, 256, (48, 40), np.uint8), "L")
    out["pil_rgba"] = pil_png(RNG.integers(0, 256, (30, 50, 4), np.uint8), "RGBA")
    out["pil_la"] = pil_png(RNG.integers(0, 256, (33, 33, 2), np.uint8), "LA")
    out["pil_palette"] = pil_png(RNG.integers(0, 256, (40, 48), np.uint8), "P",
                                 palette=list(RNG.integers(0, 256, 768)))
    out["pil_optimized"] = pil_png(RNG.integers(0, 4, (64, 64, 3), np.uint8) * 60, "RGB",
                                   optimize=True)
    for ctype, ch in ((0, 1), (2, 3), (4, 2), (6, 4)):
        px = RNG.integers(0, 256, (37, 53, ch), np.uint8)
        out[f"filters_ct{ctype}"] = timg.encode_png(px if ch > 1 else px[..., 0], ctype,
                                                    filters=(0, 1, 2, 3, 4))
    pal = RNG.integers(0, 256, (200, 3), np.uint8)   # indices past the palette read black
    out["filters_ct3"] = timg.encode_png(RNG.integers(0, 256, (29, 31), np.uint8), 3,
                                         filters=(4, 3, 2, 1, 0), palette=pal)
    yy, xx = np.mgrid[0:480, 0:640]
    smooth = np.stack([xx * 255 // 639, yy * 255 // 479, (xx + yy) % 256], -1).astype(np.uint8)
    out["smooth_640x480"] = timg.encode_png(smooth, 2, filters=(0, 1, 2, 3, 4))
    out["one_row"] = timg.encode_png(RNG.integers(0, 256, (1, 300, 3), np.uint8), 2,
                                     filters=(3,))
    return out


IMAGES = _images()


@pytest.mark.parametrize("size", [64, 448, 16])
@pytest.mark.parametrize("name", list(IMAGES))
def test_decode_image_equals_pil(name, size):
    np.testing.assert_array_equal(timg.decode_image(IMAGES[name], size), pil(IMAGES[name], size))


def test_an_image_at_its_size_is_not_resampled():
    data = IMAGES["png_bytes1"]
    np.testing.assert_array_equal(timg.decode_image(data, 48), pil(data, 48))
    np.testing.assert_array_equal(timg.decode_image(data, 48),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _refused() -> list[tuple[str, bytes, str]]:
    jpeg, gif = io.BytesIO(), io.BytesIO()
    Image.fromarray(RNG.integers(0, 256, (16, 16, 3), np.uint8)).save(jpeg, format="JPEG")
    Image.fromarray(RNG.integers(0, 256, (16, 16), np.uint8)).save(gif, format="GIF")
    wide = io.BytesIO()
    Image.fromarray(RNG.integers(0, 65535, (8, 8), np.uint16)).save(wide, format="PNG")
    ok = timg.encode_png(RNG.integers(0, 256, (8, 8, 3), np.uint8))
    ihdr = ok.index(b"IHDR")
    interlaced = bytearray(ok)
    body = bytearray(ok[ihdr + 4:ihdr + 17])
    body[12] = 1
    interlaced[ihdr - 4:ihdr + 21] = _chunk(b"IHDR", bytes(body))
    bad_crc = bytearray(ok)
    bad_crc[ihdr + 17] ^= 0xFF
    few = pil_png(RNG.integers(0, 16, (8, 8), np.uint8), "P",
                  palette=list(RNG.integers(0, 256, 48)))    # PIL packs 16 colours in 4 bits
    return [("jpeg", jpeg.getvalue(), "JPEG images are not read"),
            ("4-bit palette", few, "bit depth 4 is not read"),
            ("gif", gif.getvalue(), "GIF images are not read"),
            ("16-bit", wide.getvalue(), "bit depth 16 is not read"),
            ("interlaced", bytes(interlaced), "interlaced"),
            ("bad crc", bytes(bad_crc), "bad CRC"),
            ("garbage", b"hello world", "cannot identify image file"),
            ("truncated", ok[:40], "truncated")]


@pytest.mark.parametrize("name,data,needle", _refused(), ids=[c[0] for c in _refused()])
def test_refused_by_name(name, data, needle):
    with pytest.raises(ValueError, match=needle):
        timg.decode_image(data, 64)


def _carried(cfg: jv.VisionConfig):
    jp = jv.init_vision_params(cfg)
    return jp, tv.vision_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tol(ref: np.ndarray) -> float:
    return 1e-5 * float(np.abs(ref).max()) + 1e-6


@pytest.mark.parametrize("image_size,tokens,lm_hidden", [(64, 8, 64), (448, 4, 96)])
def test_encode_patches_equals_jaxs(image_size, tokens, lm_hidden):
    jcfg = jv.VisionConfig(image_size=image_size, num_image_tokens=tokens,
                           lm_hidden_size=lm_hidden)
    tcfg = tv.VisionConfig(**dataclasses.asdict(jcfg))
    jp, tp = _carried(jcfg)
    x = RNG.random((2, jcfg.num_patches, jcfg.patch_dim), dtype=np.float32)
    ref = np.asarray(jv.encode_patches(jp, jcfg, x))
    got = tv.encode_patches(tp, tcfg, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, tokens, lm_hidden)
    assert np.abs(got - ref).max() <= _tol(ref)


def test_encoder_equals_jaxs_on_images():
    jcfg = jv.VisionConfig(num_image_tokens=4, lm_hidden_size=64)
    jp, tp = _carried(jcfg)
    jenc = jv.VisionEncoder(jcfg)
    tenc = tv.VisionEncoder(tv.VisionConfig(num_image_tokens=4, lm_hidden_size=64),
                            device="cpu", params=tp)
    imgs = [IMAGES["png_bytes1"], IMAGES["pil_rgba"], IMAGES["filters_ct3"]]
    ref, got = jenc.encode(imgs), tenc.encode(imgs)
    assert got.dtype == np.float32 and got.shape == ref.shape == (3, 4, 64)
    assert np.abs(got - ref).max() <= _tol(ref)
    assert set(tenc.last_timing) == {"decode_ms", "device_ms"}


def test_the_ports_own_weights_are_seeded():
    cfg = tv.VisionConfig(num_image_tokens=4, lm_hidden_size=64)
    a, b = tv.init_vision_params(cfg, "cpu"), tv.init_vision_params(cfg, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in ("patch_proj", "pos", "queries", "out_proj"))
    other = tv.init_vision_params(dataclasses.replace(cfg, seed=8), "cpu")
    assert not torch.equal(a["patch_proj"], other["patch_proj"])
    enc = tv.VisionEncoder(cfg, device="cpu")
    out = enc.encode([IMAGES["png_bytes1"]] * 2)
    assert out.shape == (2, 4, 64) and np.isfinite(out).all() and np.array_equal(out[0], out[1])


# ---------------------------------------------------------------------------
# The launcher's in-process encoder behind HTTP, against JAX's
# ---------------------------------------------------------------------------

def _chat_body(model: str, image: bytes, mime: str = "image/png") -> dict:
    url = f"data:{mime};base64," + base64.b64encode(image).decode()
    return {"model": model, "max_tokens": 6, "temperature": 0, "logprobs": True,
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": "describe "},
                {"type": "image_url", "image_url": {"url": url}}]}]}


def test_in_process_encoder_chats_equal_jaxs():
    from dynamo_tpu.engine import engine as jeng
    from dynamo_tpu.frontend.model_manager import ModelManager as JModelManager
    from dynamo_tpu.frontend.service import HttpService as JHttpService
    from dynamo_tpu.models import llama as jl
    from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
    from dynamo_tpu.preprocessor.preprocessor import ModelDefaults as JDefaults
    from dynamo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
    from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
    from dynamo_tpu_torch.engine import engine as teng
    from dynamo_tpu_torch.frontend.model_manager import ModelManager as TModelManager
    from dynamo_tpu_torch.frontend.service import HttpService as THttpService
    from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
    from dynamo_tpu_torch.models.loader import from_jax_params
    from dynamo_tpu_torch.preprocessor.preprocessor import ModelDefaults as TDefaults
    from dynamo_tpu_torch.tokenizer import ByteTokenizer as TByteTokenizer
    from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
    from tests.test_torch_engine import _tcfg
    from tests.test_torch_http_e2e import post

    name = "tiny-llama-f32-vision"
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32", name=name)
    JAX_PRESETS[name], TORCH_PRESETS[name] = jcfg, _tcfg(jcfg)
    lm = jl.init_params(jcfg, jax.random.key(2))
    kw = dict(model=name, block_size=4, num_blocks=128, max_batch_size=4, max_model_len=256)
    vcfg = jv.VisionConfig(num_image_tokens=4, lm_hidden_size=jcfg.hidden_size)
    jvp, tvp = _carried(vcfg)
    jvenc = jv.VisionEncoder(vcfg)
    tvenc = tv.VisionEncoder(tv.VisionConfig(**dataclasses.asdict(vcfg)), device="cpu",
                             params=tvp)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(120)

    def in_process(venc):   # launch/run.py's image_encoder of either package
        async def image_encoder(imgs):
            out = await asyncio.get_running_loop().run_in_executor(None, venc.encode, imgs)
            return [out[i] for i in range(len(imgs))]
        return image_encoder

    jengine = jeng.build_engine(JEngineConfig(**kw), params=lm)
    tengine = teng.build_engine(TEngineConfig(**kw), device="cpu",
                                params=from_jax_params(jax.tree.map(np.asarray, lm), "cpu"))
    jm, tm = JModelManager(), TModelManager()
    jm.register("mm", JByteTokenizer(), jengine.generate, defaults=JDefaults(),
                image_encoder=in_process(jvenc))
    tm.register("mm", TByteTokenizer(), tengine.generate, defaults=TDefaults(),
                image_encoder=in_process(tvenc))
    jsvc, tsvc = JHttpService(jm), THttpService(tm)
    try:
        jport, tport = run(jsvc.start(port=0)), run(tsvc.start(port=0))
        answers = []
        for img in (IMAGES["png_bytes1"], IMAGES["filters_ct0"], IMAGES["png_bytes1"]):
            j = post(jport, "/v1/chat/completions", _chat_body("mm", img))
            t = post(tport, "/v1/chat/completions", _chat_body("mm", img))
            assert t[0] == j[0] == 200, (t, j)
            jd, td = json.loads(j[1]), json.loads(t[1])
            jl_ = [e["logprob"] for e in jd["choices"][0]["logprobs"]["content"]]
            tl_ = [e["logprob"] for e in td["choices"][0]["logprobs"]["content"]]
            assert td["choices"][0]["message"]["content"] == jd["choices"][0]["message"]["content"]
            assert [e["token"] for e in td["choices"][0]["logprobs"]["content"]] == \
                [e["token"] for e in jd["choices"][0]["logprobs"]["content"]]
            assert np.allclose(tl_, jl_, atol=1e-4), (tl_, jl_)
            assert td["usage"] == jd["usage"]
            answers.append(tl_)
        assert answers[0] == answers[2] and answers[0] != answers[1]
        # a JPEG: JAX's PIL reads it, the port refuses it by name
        jpeg = io.BytesIO()
        Image.fromarray(RNG.integers(0, 256, (16, 16, 3), np.uint8)).save(jpeg, format="JPEG")
        status, data = post(tport, "/v1/chat/completions", _chat_body("mm", jpeg.getvalue(),
                                                                      "image/jpeg"))
        assert status == 400 and b"JPEG images are not read" in data
    finally:
        for coro in (jsvc.stop(), tsvc.stop(), jengine.shutdown(), tengine.shutdown()):
            run(coro)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
        del JAX_PRESETS[name], TORCH_PRESETS[name]


# ---------------------------------------------------------------------------
# The encode worker and the frontend as processes
# ---------------------------------------------------------------------------

def test_encode_worker_and_frontend_end_to_end_on_cpu():
    coord_port, http_port = free_port(), free_port()
    url = f"tcp://127.0.0.1:{coord_port}"
    procs: list[Proc] = []

    def start(args, name, ready):
        p = Proc(args, name).start()
        procs.append(p)
        return p, ready

    try:
        c, _ = start(["-m", "dynamo_tpu_torch.transports.coordinator", "--host", "127.0.0.1",
                      "--port", str(coord_port)], "coordinator", None)
        c.wait_for_line("COORDINATOR_READY", 30)
        waits = [
            start(["-m", "dynamo_tpu_torch.components.worker", "--device", "cpu",
                   "--coordinator", url, "--model", "tiny-llama", "--dtype", "float32",
                   "--block-size", "4", "--num-blocks", "128", "--max-model-len", "256",
                   "--max-batch-size", "4", "--warmup-mode", "off"], "worker", "WORKER_READY"),
            start(["-m", "dynamo_tpu_torch.components.encode", "--device", "cpu",
                   "--coordinator", url, "--image-tokens", "4", "--lm-hidden", "64"],
                  "encode", "ENCODE_READY"),
            start(["-m", "dynamo_tpu_torch.components.frontend", "--coordinator", url,
                   "--host", "127.0.0.1", "--port", str(http_port),
                   "--encoder-endpoint", "dyn://dynamo.encoder.encode"],
                  "frontend", "FRONTEND_READY"),
        ]
        for p, ready in waits:
            p.wait_for_line(ready, 90)
        base = f"http://127.0.0.1:{http_port}/v1/chat/completions"

        def lps(r):
            return [e["logprob"] for e in r["choices"][0]["logprobs"]["content"]]

        first = None
        for _ in range(300):     # the frontend discovers the worker's model
            try:
                first = http_json(base, _chat_body("tiny-llama", IMAGES["png_bytes1"]), 60)
                break
            except urllib.error.HTTPError as exc:
                assert exc.code == 404, exc.read()
                time.sleep(0.1)
        assert first is not None and first["choices"][0]["finish_reason"] == "length"
        again = http_json(base, _chat_body("tiny-llama", IMAGES["png_bytes1"]), 60)
        other = http_json(base, _chat_body("tiny-llama", IMAGES["smooth_640x480"]), 60)
        assert lps(again) == lps(first) and lps(other) != lps(first)
        jpeg = io.BytesIO()
        Image.fromarray(RNG.integers(0, 256, (16, 16, 3), np.uint8)).save(jpeg, format="JPEG")
        with pytest.raises(urllib.error.HTTPError) as err:
            http_json(base, _chat_body("tiny-llama", jpeg.getvalue(), "image/jpeg"), 60)
        assert err.value.code == 400
        assert "bad image: JPEG images are not read" in err.value.read().decode()
        encode = next(p for p in procs if p.name == "encode")
        assert "encoded 1 image(s): decode+resize" in encode.logs()
    finally:
        for p in reversed(procs):
            p.stop()
