"""The port's stream recorder (``dynamo_tpu_torch/utils/recorder.py``, over
the port's coordinator client and MessagePack codec) against the JAX
package's: both record the same subject off one coordinator, and the same
frames give equal JSONL lines (apart from the receive time), equal router
events on replay, and the same prefix matches in the port's indexer. The
CLI records a subject until SIGINT.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import msgpack

from dynamo_tpu.utils import recorder as jrec
from dynamo_tpu_torch.router.events import BlockRemoved, BlockStored, RouterEvent
from dynamo_tpu_torch.router.indexer import RadixIndexer
from dynamo_tpu_torch.transports.client import CoordinatorClient
from dynamo_tpu_torch.transports.coordinator import CoordinatorServer
from dynamo_tpu_torch.utils import msgpack as tmsgpack
from dynamo_tpu_torch.utils import recorder as trec

ROOT = Path(__file__).resolve().parent.parent
SUBJECT = "kv_events.dynamo.backend"


def frames() -> list[bytes]:
    events = [
        RouterEvent(worker_id=7, event=BlockStored(block_hashes=(11, 22, 33), parent_hash=None)),
        RouterEvent(worker_id=9, event=BlockStored(block_hashes=(11, 44), parent_hash=None)),
        RouterEvent(worker_id=9, event=BlockRemoved(block_hashes=(44,))),
    ]
    return [
        tmsgpack.packb([e.to_dict() for e in events[:2]]),
        msgpack.packb([events[2].to_dict()], use_bin_type=True),
        tmsgpack.packb({"load": 0.5, "blob": b"\x00\x01", "name": "w"}),
        b"\xc1 not msgpack",                       # recorded as _raw_hex
        tmsgpack.packb([{"worker_id": 1, "bogus": True}]),   # skipped on replay
    ]


def strip_time(path: str) -> list[dict]:
    out = []
    for rec in jrec.iter_records(path):
        assert isinstance(rec.pop("t"), float)
        out.append(rec)
    return out


async def _record(tmp: Path) -> tuple[str, str]:
    from dynamo_tpu.transports.client import CoordinatorClient as JClient

    server = CoordinatorServer(host="127.0.0.1", port=0)
    port = await server.start()
    url = f"tcp://127.0.0.1:{port}"
    tcoord, jcoord, pub = (await CoordinatorClient.connect(url), await JClient.connect(url),
                           await CoordinatorClient.connect(url))
    t_out, j_out = str(tmp / "port.jsonl"), str(tmp / "jax.jsonl")
    recs = [trec.StreamRecorder(tcoord, SUBJECT, t_out), jrec.StreamRecorder(jcoord, SUBJECT, j_out)]
    try:
        for r in recs:
            await r.start()
        await asyncio.sleep(0.1)
        for f in frames():
            await pub.publish(SUBJECT, f)
        deadline = time.monotonic() + 10
        while any(r.count < len(frames()) for r in recs):
            assert time.monotonic() < deadline, [r.count for r in recs]
            await asyncio.sleep(0.05)
    finally:
        for r in recs:
            await r.stop()
        for c in (tcoord, jcoord, pub):
            await c.close()
        await server.stop()
    return t_out, j_out


def test_the_same_frames_give_the_same_records_and_events(tmp_path):
    t_out, j_out = asyncio.run(_record(tmp_path))
    t_lines, j_lines = strip_time(t_out), strip_time(j_out)
    assert t_lines == j_lines and len(t_lines) == len(frames())
    assert t_lines[3]["payload"] == {"_raw_hex": frames()[3].hex()}
    t_events = trec.load_router_events(t_out)
    j_events = jrec.load_router_events(j_out)
    assert [e.to_dict() for e in t_events] == [e.to_dict() for e in j_events]
    assert len(t_events) == 3
    idx = RadixIndexer()
    for e in t_events:
        idx.apply_event(e)
    assert idx.find_matches([11, 22, 33]).scores == {7: 3, 9: 1}


def test_the_cli_records_until_sigint(tmp_path):
    async def main():
        server = CoordinatorServer(host="127.0.0.1", port=0)
        port = await server.start()
        out = tmp_path / "cli.jsonl"
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.utils.recorder", "--coordinator",
             f"tcp://127.0.0.1:{port}", "--subject", SUBJECT, "--subject", "load.x",
             "--out", str(out)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, "DYN_LOG": "info"})
        pub = await CoordinatorClient.connect(f"tcp://127.0.0.1:{port}")
        try:
            deadline = time.monotonic() + 60
            while not out.exists() or not out.read_text():
                assert time.monotonic() < deadline and proc.poll() is None
                await pub.publish(SUBJECT, frames()[0])
                await pub.publish("load.x", frames()[2])
                await asyncio.sleep(0.2)
            proc.send_signal(signal.SIGINT)
            rc = await asyncio.get_running_loop().run_in_executor(None, proc.wait, 30)
        finally:
            if proc.poll() is None:
                proc.kill()
            await pub.close()
            await server.stop()
        return rc, out, proc.stdout.read()

    rc, out, logs = asyncio.run(main())
    assert rc == 0, logs
    subjects = {json.loads(ln)["subject"] for ln in out.read_text().splitlines()}
    assert SUBJECT in subjects and "recorded" in logs
