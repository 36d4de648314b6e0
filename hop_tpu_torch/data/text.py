"""Text normalisation helpers (port of hop_tpu/data/text.py; reference
data_loader/data_utils.py:18-31)."""

from __future__ import annotations

import re


def normalize_string(s: str) -> str:
    """lowercase, trim, isolate punctuation, strip non-letters."""
    s = s.lower().strip()
    s = re.sub(r"([,.!?])", r" \1 ", s)
    s = re.sub(r"(['])", r"", s)
    s = re.sub(r"[^a-zA-Z,.!?]+", r" ", s)
    s = re.sub(r"\s+", r" ", s).strip()
    return s


def remove_tags_marks(text: str) -> str:
    return re.sub(re.compile(r"<.*?>|[.,:;!?]+"), "", text)
