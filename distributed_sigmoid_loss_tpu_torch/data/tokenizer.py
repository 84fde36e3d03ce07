"""Tokenizers: the text front end, the port's copy of the JAX package's
``data/tokenizer.py`` (pure numpy; the same ids and the same trained vocab
JSON). Two implementations share one interface (``__call__`` / ``encode`` /
``decode``):

- :class:`ByteTokenizer`: UTF-8 bytes + pad/bos/eos, no setup (vocab 259).
- :class:`BpeTokenizer`: byte-level BPE trained on a caption corpus (the
  GPT-2-family merge algorithm): base vocab = the 256 bytes, merges learned
  greedily by pair frequency up to ``vocab_size``. Lossless, JSON
  save/load, used by ``train --tokenizer``.

Output is a dense (batch, context_length) int32 array, padded to length.
"""

from __future__ import annotations

import json
import re

import numpy as np

__all__ = ["ByteTokenizer", "BpeTokenizer"]


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids = byte value + 3; 0/1/2 = pad/bos/eos."""

    pad_id = 0
    bos_id = 1
    eos_id = 2
    _offset = 3
    vocab_size = 256 + _offset

    def __init__(self, add_bos: bool = True, add_eos: bool = True):
        self.add_bos = add_bos
        self.add_eos = add_eos

    def encode(self, text: str) -> list[int]:
        """Token ids for one string, without padding/truncation."""
        ids = [b + self._offset for b in text.encode("utf-8")]
        if self.add_bos:
            ids.insert(0, self.bos_id)
        if self.add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids) -> str:
        """Inverse of :meth:`encode`; pad/bos/eos are dropped. Truncation can split
        a multi-byte UTF-8 character — invalid tails decode with replacement."""
        data = bytes(
            int(i) - self._offset for i in np.asarray(ids).reshape(-1)
            if int(i) >= self._offset
        )
        return data.decode("utf-8", errors="replace")

    def __call__(self, texts, context_length: int) -> np.ndarray:
        """Batch-encode to a dense (len(texts), context_length) int32 array.

        Sequences longer than ``context_length`` are truncated (keeping eos as the
        final token when enabled, matching the usual CLIP/SigLIP convention);
        shorter ones are right-padded with ``pad_id``.
        """
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_length), self.pad_id, np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)
            if len(ids) > context_length:
                ids = ids[:context_length]
                if self.add_eos:
                    ids[-1] = self.eos_id
            out[row, : len(ids)] = ids
        return out


# Alternating word/whitespace pieces: lossless concatenation, merges never
# cross a word boundary (the classic BPE scoping rule).
_PIECE_RE = re.compile(r"\S+|\s+")


class BpeTokenizer(ByteTokenizer):
    """Byte-level BPE with a trainable merge table (see module docstring).

    Ids: 0/1/2 pad/bos/eos, 3..258 the raw bytes (ByteTokenizer-compatible —
    zero merges IS the byte tokenizer), 259+ one id per learned merge, in
    merge order. ``merges`` is the training artifact: a list of (left, right)
    token-id pairs; encoding applies them greedily by rank, which reproduces
    the training segmentation.
    """

    def __init__(self, merges=(), add_bos: bool = True, add_eos: bool = True):
        super().__init__(add_bos=add_bos, add_eos=add_eos)
        self.merges = [tuple(m) for m in merges]
        self.vocab_size = 256 + self._offset + len(self.merges)
        self._ranks = {pair: i for i, pair in enumerate(self.merges)}
        # id -> bytes, for decode. Built in merge order: children always exist.
        self._token_bytes = {i + self._offset: bytes([i]) for i in range(256)}
        for i, (a, b) in enumerate(self.merges):
            self._token_bytes[256 + self._offset + i] = (
                self._token_bytes[a] + self._token_bytes[b]
            )

    # -- training ----------------------------------------------------------
    @classmethod
    def train(cls, texts, vocab_size: int, **kw) -> "BpeTokenizer":
        """Learn merges from an iterable of strings.

        Classic BPE: count adjacent-pair frequencies over the piece-frequency
        table, merge the most frequent pair (ties broken by token ids for
        determinism), repeat until ``vocab_size`` or no pair occurs twice.
        """
        base = 256 + cls._offset
        if vocab_size < base:
            raise ValueError(
                f"vocab_size must be >= {base} (bytes + specials), got {vocab_size}"
            )
        freqs: dict[tuple, int] = {}
        for text in texts:
            for piece in _PIECE_RE.findall(text):
                ids = tuple(b + cls._offset for b in piece.encode("utf-8"))
                if ids:
                    freqs[ids] = freqs.get(ids, 0) + 1

        # Incremental pair bookkeeping (what makes a 4096-vocab train linear-ish
        # instead of quadratic): pair counts and a pair -> piece-index inverted
        # index are built ONCE; each merge touches only the pieces that contain
        # the merged pair, decrementing their old pairs and adding the new ones.
        pieces = list(freqs.keys())
        counts = [freqs[p] for p in pieces]
        pair_counts: dict[tuple[int, int], int] = {}
        where: dict[tuple[int, int], set[int]] = {}

        def account(idx: int, sign: int) -> None:
            ids, n = pieces[idx], counts[idx]
            for pair in zip(ids, ids[1:]):
                pair_counts[pair] = pair_counts.get(pair, 0) + sign * n
                if sign > 0:
                    where.setdefault(pair, set()).add(idx)
                elif pair_counts[pair] <= 0:
                    pair_counts.pop(pair, None)
                    where.pop(pair, None)

        for i in range(len(pieces)):
            account(i, +1)

        merges: list[tuple[int, int]] = []
        next_id = base
        while next_id < vocab_size and pair_counts:
            best = max(pair_counts, key=lambda p: (pair_counts[p], (-p[0], -p[1])))
            if pair_counts[best] < 2:
                break  # nothing repeats; further merges would memorize noise
            merges.append(best)
            for idx in list(where.get(best, ())):
                account(idx, -1)
                pieces[idx] = cls._merge_ids(list(pieces[idx]), best, next_id)
                account(idx, +1)
                # A piece may keep stale index entries for pairs it no longer
                # contains (sets only grow on +1); account(-1) handles them by
                # count, and the `best` entry itself is dropped below.
            pair_counts.pop(best, None)
            where.pop(best, None)
            next_id += 1
        return cls(merges, **kw)

    @staticmethod
    def _merge_ids(ids, pair, new_id):
        out = []
        i = 0
        while i < len(ids):
            if i + 1 < len(ids) and (ids[i], ids[i + 1]) == pair:
                out.append(new_id)
                i += 2
            else:
                out.append(ids[i])
                i += 1
        return tuple(out)

    # -- encode / decode ---------------------------------------------------
    def encode(self, text: str) -> list[int]:
        out = [self.bos_id] if self.add_bos else []
        for piece in _PIECE_RE.findall(text):
            ids = [b + self._offset for b in piece.encode("utf-8")]
            while len(ids) >= 2:
                pairs = set(zip(ids, ids[1:]))
                best = min(
                    pairs, key=lambda p: self._ranks.get(p, len(self.merges))
                )
                if best not in self._ranks:
                    break
                ids = list(self._merge_ids(
                    ids, best, 256 + self._offset + self._ranks[best]
                ))
            out.extend(ids)
        if self.add_eos:
            out.append(self.eos_id)
        return out

    def decode(self, ids) -> str:
        data = b"".join(
            self._token_bytes[int(i)]
            for i in np.asarray(ids).reshape(-1)
            if int(i) >= self._offset
        )
        return data.decode("utf-8", errors="replace")

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"format": "dsl-bpe-v1", "merges": self.merges},
                f,
            )

    @classmethod
    def load(cls, path: str, **kw) -> "BpeTokenizer":
        with open(path) as f:
            blob = json.load(f)
        if blob.get("format") != "dsl-bpe-v1":
            raise ValueError(
                f"{path!r} is not a dsl-bpe-v1 vocab file "
                f"(format={blob.get('format')!r})"
            )
        return cls(blob["merges"], **kw)
