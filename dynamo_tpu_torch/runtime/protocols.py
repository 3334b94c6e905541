"""Endpoint addressing: ``dyn://namespace.component.endpoint``.

Reference: lib/runtime/src/protocols.rs (EndpointId parse) and the etcd path
layout in component.rs (INSTANCE_ROOT_PATH).

Copy of ``dynamo_tpu/runtime/protocols.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

INSTANCE_PREFIX = "dyn/instances"
MODEL_PREFIX = "dyn/models"
METRICS_PREFIX = "dyn/metrics"


@dataclass(frozen=True)
class EndpointId:
    namespace: str
    component: str
    endpoint: str

    @classmethod
    def parse(cls, s: str) -> "EndpointId":
        s = s.removeprefix("dyn://")
        parts = s.split(".")
        if len(parts) != 3 or not all(parts):
            raise ValueError(f"bad endpoint id {s!r}; want ns.component.endpoint")
        return cls(*parts)

    def __str__(self) -> str:
        return f"dyn://{self.namespace}.{self.component}.{self.endpoint}"

    @property
    def instance_prefix(self) -> str:
        return f"{INSTANCE_PREFIX}/{self.namespace}/{self.component}/{self.endpoint}/"

    def instance_key(self, instance_id: int) -> str:
        return f"{self.instance_prefix}{instance_id:016x}"


@dataclass(frozen=True)
class MetricsTarget:
    """A scrapeable /metrics endpoint, registered under METRICS_PREFIX and
    bound to its owner's primary lease: lease death deletes the key, so the
    fleet aggregator's discovery view tracks process liveness with no
    static target lists (reference: the Prometheus service-discovery role
    etcd registration plays for the reference metrics aggregator)."""

    role: str           # "frontend" | "worker" | "router" | ...
    instance_id: int
    url: str            # http base URL; <url>/metrics serves the exposition
    namespace: str = ""

    @property
    def key(self) -> str:
        return f"{METRICS_PREFIX}/{self.namespace}/{self.role}/{self.instance_id:016x}"

    @property
    def instance(self) -> str:
        """Stable per-target label value for the fleet exposition."""
        return self.url.split("//", 1)[-1].rstrip("/")

    def to_bytes(self) -> bytes:
        return json.dumps({
            "role": self.role,
            "instance_id": self.instance_id,
            "url": self.url,
            "namespace": self.namespace,
        }).encode()

    @classmethod
    def from_bytes(cls, data: bytes) -> "MetricsTarget":
        d = json.loads(data)
        return cls(role=d["role"], instance_id=d["instance_id"],
                   url=d["url"], namespace=d.get("namespace", ""))


@dataclass(frozen=True)
class Instance:
    """A live endpoint instance (reference: component.rs Instance)."""

    endpoint: EndpointId
    instance_id: int
    address: str        # host:port of the worker's data-plane server
    lease_id: int = 0

    def to_bytes(self) -> bytes:
        return json.dumps({
            "namespace": self.endpoint.namespace,
            "component": self.endpoint.component,
            "endpoint": self.endpoint.endpoint,
            "instance_id": self.instance_id,
            "address": self.address,
            "lease_id": self.lease_id,
        }).encode()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Instance":
        d = json.loads(data)
        return cls(
            endpoint=EndpointId(d["namespace"], d["component"], d["endpoint"]),
            instance_id=d["instance_id"],
            address=d["address"],
            lease_id=d.get("lease_id", 0),
        )
