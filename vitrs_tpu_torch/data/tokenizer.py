"""Self-contained GPT-2-style byte-level BPE tokenizer — the port's copy of
`vitrs_tpu/data/tokenizer.py`, which is pure Python already but can only be
imported through `vitrs_tpu/__init__.py`, which imports jax.  The code is
unchanged; tests/test_torch_serving_gen.py pins equal ids after training.

The reference's input modality is raw token ids (rusty_vit.rs:73); it has
no tokenizer, so this is beyond-reference surface that lets the serving
stack speak text.

Design follows the GPT-2 scheme (Radford et al. 2019; the byte↔unicode
trick of openai/gpt-2 encoder.py re-derived from its published description):

* Every byte 0-255 maps to a printable unicode codepoint, so BPE operates on
  unicode strings with NO unknown symbols and decode is a lossless inverse
  (arbitrary bytes round-trip, not just valid UTF-8).
* A regex pre-splitter keeps merges from crossing word/space boundaries.
  GPT-2's pattern uses \\p{L}/\\p{N}; stdlib `re` lacks those classes, so an
  equivalent is built from re's unicode-aware \\w (letters ≈ \\w minus digits
  and _). Exact GPT-2-vocab compatibility additionally needs OpenAI's
  published merges file — `from_gpt2_files` loads that format when present
  locally (zero-egress builds cannot fetch it).
* Merges are trained greedily: count adjacent-pair frequencies over the
  pre-split words, merge the most frequent, repeat — the standard BPE
  training loop (Sennrich et al. 2016).
* With no merges at all the tokenizer degrades to plain byte fallback
  (vocab = 256 + specials) — still a complete, lossless text path.

No third-party deps; encode/decode are pure Python over dict lookups.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# --- byte <-> unicode bijection (printable-codepoint trick) ----------------


def _bytes_to_unicode() -> Dict[int, str]:
    """256-entry bijection byte -> single unicode char.  Printable ASCII and
    latin-1 glyphs map to themselves; the remaining 68 control/space bytes
    shift up past 255 so every token string is visible text."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_B2U = _bytes_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}

# GPT-2's pre-split pattern with stdlib-re substitutes for \p{L}/\p{N}:
# letters = word chars minus digits/underscore, numbers = \d (unicode).
# The "other" class must be the exact complement {not space, not letter,
# not digit} — GPT-2's [^\s\p{L}\p{N}] — expressed with lookaheads; the
# naive [^\s\w] silently DROPPED '_' and any \w char that is neither
# letter nor digit, making encode/decode lossy on e.g. snake_case source.
_L = r"[^\W\d_]"
_N = r"\d"
_OTHER = rf"(?:(?!{_L})(?!{_N})\S)"
_PRESPLIT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d"
    rf"| ?{_L}+| ?{_N}+"
    rf"| ?{_OTHER}+|\s+(?!\S)|\s+",
    re.UNICODE)


def _get_pairs(word: Tuple[str, ...]) -> set:
    return set(zip(word[:-1], word[1:]))


class ByteBPETokenizer:
    """encode(str) -> List[int], decode(List[int]) -> str; lossless on
    arbitrary unicode text (decode_bytes exposes the raw byte stream)."""

    def __init__(self, merges: Sequence[Tuple[str, str]] = (),
                 specials: Sequence[str] = ("<|endoftext|>",)):
        self.merges: List[Tuple[str, str]] = [tuple(m) for m in merges]
        self._ranks = {m: i for i, m in enumerate(self.merges)}
        # vocab: 256 base byte-chars first, then one entry per merge, then
        # specials — contiguous ids, deterministic given (merges, specials)
        toks = [_B2U[b] for b in range(256)]
        for a, b in self.merges:
            toks.append(a + b)
        self.specials = list(specials)
        self._tok2id = {t: i for i, t in enumerate(toks)}
        for s in self.specials:
            self._tok2id[s] = len(self._tok2id)
        self._id2tok = {i: t for t, i in self._tok2id.items()}
        self._special_re = (re.compile(
            "(" + "|".join(re.escape(s) for s in self.specials) + ")")
            if self.specials else None)
        self._cache: Dict[str, List[str]] = {}

    # -- properties ---------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self._tok2id)

    def special_id(self, s: str) -> int:
        return self._tok2id[s]

    @property
    def eot_id(self) -> Optional[int]:
        return (self._tok2id.get("<|endoftext|>")
                if "<|endoftext|>" in self._tok2id else None)

    # -- BPE core -----------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        """Merge the byte-char sequence of one pre-split word."""
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = _get_pairs(word)
            best = min(pairs,
                       key=lambda p: self._ranks.get(p, float("inf")))
            if best not in self._ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        result = list(word)
        if len(self._cache) < 65536:
            self._cache[token] = result
        return result

    # -- public API ---------------------------------------------------------

    def encode_ordinary(self, text: str) -> List[int]:
        """Encode ignoring special-token strings (treat them as plain text)."""
        ids: List[int] = []
        for chunk in _PRESPLIT.findall(text):
            mapped = "".join(_B2U[b] for b in chunk.encode("utf-8"))
            ids.extend(self._tok2id[t] for t in self._bpe(mapped))
        return ids

    def encode(self, text: str) -> List[int]:
        """Encode; occurrences of special strings become their single id."""
        if not self._special_re:
            return self.encode_ordinary(text)
        ids: List[int] = []
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self._tok2id and part in self.specials:
                ids.append(self._tok2id[part])
            else:
                ids.extend(self.encode_ordinary(part))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        out = bytearray()
        for i in ids:
            tok = self._id2tok[int(i)]
            if tok in self.specials:
                out.extend(tok.encode("utf-8"))
            else:
                out.extend(_U2B[u] for u in tok)
        return bytes(out)

    # -- training -----------------------------------------------------------

    @classmethod
    def train(cls, text: str, vocab_size: int,
              specials: Sequence[str] = ("<|endoftext|>",)
              ) -> "ByteBPETokenizer":
        """Greedy BPE merge training on `text` until vocab_size is reached
        (256 base tokens + merges + specials)."""
        n_merges = vocab_size - 256 - len(specials)
        assert n_merges >= 0, f"vocab_size {vocab_size} < base {256 + len(specials)}"
        # word -> count over the pre-split corpus, as byte-char tuples
        counts: Dict[Tuple[str, ...], int] = {}
        for chunk in _PRESPLIT.findall(text):
            key = tuple(_B2U[b] for b in chunk.encode("utf-8"))
            counts[key] = counts.get(key, 0) + 1
        merges: List[Tuple[str, str]] = []
        words = [[list(w), c] for w, c in counts.items()]
        for _ in range(n_merges):
            pair_counts: Dict[Tuple[str, str], int] = {}
            for w, c in words:
                for p in zip(w[:-1], w[1:]):
                    pair_counts[p] = pair_counts.get(p, 0) + c
            if not pair_counts:
                break
            # deterministic: max count, ties by lexicographic pair
            best = max(pair_counts, key=lambda p: (pair_counts[p], p))
            if pair_counts[best] < 2:
                break
            merges.append(best)
            a, b = best
            ab = a + b
            for item in words:
                w = item[0]
                if a not in w:
                    continue
                out, i = [], 0
                while i < len(w):
                    if i < len(w) - 1 and w[i] == a and w[i + 1] == b:
                        out.append(ab)
                        i += 2
                    else:
                        out.append(w[i])
                        i += 1
                item[0] = out
        return cls(merges, specials)

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"version": 1, "merges": self.merges,
                       "specials": self.specials}, f, ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "ByteBPETokenizer":
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        assert d.get("version") == 1, d.get("version")
        return cls([tuple(m) for m in d["merges"]], d["specials"])

    @classmethod
    def from_gpt2_files(cls, merges_txt: str,
                        specials: Sequence[str] = ("<|endoftext|>",)
                        ) -> "ByteBPETokenizer":
        """Load OpenAI's published merges.txt format (one 'a b' pair per
        line, '#version' header).  Note: id assignment here is canonical
        (256 bytes, then merges in rank order) which coincides with GPT-2's
        released vocab.json ordering."""
        merges = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(merges, specials)
