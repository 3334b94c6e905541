"""TLS configuration shared by every ingress (HTTP + gRPC).

Copy of ``dynamo_tpu/utils/tls.py``.
"""

from __future__ import annotations


def validate_tls_pair(tls_cert: str | None, tls_key: str | None) -> bool:
    """True → serve TLS; False → plaintext. One copy of the pair rule,
    callable before any server setup side effects."""
    if tls_cert or tls_key:
        if not (tls_cert and tls_key):
            raise ValueError(
                "TLS needs both a certificate and a private key "
                "(--tls-cert/--tls-key on the frontend CLI)")
        return True
    return False
