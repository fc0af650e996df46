"""Simple tokenizer for TEXT fields: lowercase + split on non-alphanumeric
(the behavior of tantivy's default SimpleTokenizer + LowerCaser pipeline)."""

import re

_SPLIT = re.compile(r"[^0-9a-z]+")


def tokenize(text: str) -> list:
    return [t for t in _SPLIT.split(str(text).lower()) if t]
