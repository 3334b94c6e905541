"""Shared text-streaming helpers.

Copy of ``dynamo_tpu/utils/text.py``.
"""

from __future__ import annotations

from typing import Iterable


def longest_partial_suffix(text: str, markers: Iterable[str]) -> int:
    """Length of the longest suffix of ``text`` that is a proper prefix of
    any marker — the amount of text a streaming stage must withhold because
    it may be the start of a marker still arriving.

    Shared by the detokenizer's stop-string jail, the reasoning parser's
    think-tag buffering, and the tool-call jail.
    """
    best = 0
    for marker in markers:
        upper = min(len(marker) - 1, len(text))
        for k in range(upper, 0, -1):
            if marker.startswith(text[-k:]):
                best = max(best, k)
                break
    return best
