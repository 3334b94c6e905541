"""Multimodal encode worker: images → embedding tokens over the runtime.

Copy of ``dynamo_tpu/components/encode.py``: a process owning the vision
encoder (models/vision.py), serving ``dyn://{ns}.encoder.encode``.
Frontends ship image bytes in the request and receive embedding tensors
in the response, on the same framed data plane as everything else. The
encoder runs on the CUDA card unless given ``--device cpu``; images decode
and resize on the host (models/image.py: PNG only). Bad image bytes answer
``{"error": "bad image: ..."}``, which the frontend maps to 400. Each
request logs its host (decode and resize) and device milliseconds.

    python -m dynamo_tpu_torch.components.encode --coordinator tcp://... \\
        --image-tokens 8 --lm-hidden 64 [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("encode")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dynamo-encode-worker")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="encoder")
    p.add_argument("--endpoint", default="encode")
    p.add_argument("--image-tokens", type=int, default=8)
    p.add_argument("--lm-hidden", type=int, default=64,
                   help="target LM hidden size (must match the served model)")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card")
    return p.parse_args(argv)


async def amain(ns: argparse.Namespace) -> None:
    # torch and the encoder load before the runtime grants the lease: the
    # import and the weights' draw block the event loop for seconds
    from dynamo_tpu_torch.models.vision import VisionConfig, VisionEncoder
    from dynamo_tpu_torch.protocols.common import tensor_to_wire

    encoder = VisionEncoder(VisionConfig(
        num_image_tokens=ns.image_tokens, lm_hidden_size=ns.lm_hidden,
        image_size=ns.image_size), device=ns.device)

    rt = await DistributedRuntime.create(
        RuntimeConfig.from_settings(coordinator_url=ns.coordinator))
    loop = asyncio.get_running_loop()

    def encode(images: list[bytes]):
        arr = encoder.encode(images)
        return arr, dict(encoder.last_timing)

    async def handler(payload: dict, ctx):
        images = payload.get("images", [])
        if not images:
            yield {"embeddings": []}
            return
        try:
            # off the loop; batched over the request's images
            arr, timing = await loop.run_in_executor(None, encode, list(images))
        except Exception as exc:  # noqa: BLE001 - bad image bytes
            # a structured client error — the frontend maps it to 400, not
            # to a 502 "encoder unavailable"
            yield {"error": f"bad image: {exc}"}
            return
        log.info("encoded %d image(s): decode+resize %.3f ms, device %.3f ms",
                 len(images), timing["decode_ms"], timing["device_ms"])
        yield {"embeddings": [tensor_to_wire(arr[i]) for i in range(len(images))]}

    ep = rt.namespace(ns.namespace).component(ns.component).endpoint(ns.endpoint)
    await ep.serve(handler)
    if rt.status_server is not None:
        rt.status_server.ready = True
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):      # before the ready line
        loop.add_signal_handler(sig, stop.set)
    log.info("encode worker ready on %s: %d tokens/image -> lm_hidden=%d",
             encoder.device, ns.image_tokens, ns.lm_hidden)
    print(f"ENCODE_READY instance={rt.instance_id:016x}", flush=True)
    await stop.wait()
    await rt.shutdown()


def main() -> None:
    configure_logging()
    asyncio.run(amain(parse_args()))


if __name__ == "__main__":
    main()
