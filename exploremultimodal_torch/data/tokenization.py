"""The BERT WordPiece tokenizer and the MLM collators, in plain Python
(counterpart of `exploremultimodal_tpu/data/tokenization.py`, which wraps
HF `transformers`' `BertTokenizerFast` and its MLM collators; the card's
machine may lack that package, so the port keeps its own copy of both).

`BertTokenizer` reproduces what `BertTokenizerFast.from_pretrained` gives
for `resource/bert-base-uncased` (`do_lower_case`, `tokenize_chinese_chars`,
`strip_accents` unset, so lowercasing strips accents): the five special
tokens are cut out of the raw text first (case-sensitive, anywhere); each
piece between them is cleaned (control characters dropped, whitespace made
a space), CJK ideographs are spaced out, accents are stripped (NFD, then
every nonspacing mark dropped) and the text is lowercased character by
character, in that order, as the Rust normalizer does; words split at
whitespace and around every punctuation character; each word becomes its
greedy longest-match WordPiece pieces (`##` continuations), or `[UNK]`
where a word is longer than 100 characters or has no match.

`MlmCollator` reproduces the draws of HF 4.57's numpy collators
(`DataCollatorForWholeWordMask` and `DataCollatorForLanguageModeling`, as
JAX builds them) from a `random.Random` and a `numpy.random.RandomState` of
its own, seeded as JAX seeds the global generators, so it needs no lock.
"""

from __future__ import annotations

import bisect
import os
import random
import re
import threading
import unicodedata
from functools import lru_cache

import numpy as np

DEFAULT_RESOURCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "resource",
)

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
_SPECIAL_RE = re.compile("|".join(re.escape(t) for t in SPECIAL_TOKENS))
# the Rust normalizer's CJK blocks (`is_chinese_char`)
_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
               (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
               (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
# the Rust normalizer's "other" categories: control, format, private use
# (unassigned code points are kept)
_DROPPED_CATEGORIES = frozenset(("Cc", "Cf", "Co", "Cs"))
# code points that Python's Unicode tables (15.0) give a category and the
# fast tokenizer's older tables do not: it treats them as plain letters
# (found by tokenizing 'a' + chr(c) + 'b' for every code point with both)
_UNKNOWN_TO_FAST = (
    (0x61D, 0x61D), (0x7FD, 0x7FD), (0x890, 0x891), (0x898, 0x89F), (0x8CA, 0x8E2),
    (0x9FD, 0x9FE), (0xA76, 0xA76), (0xAFA, 0xAFF), (0xB55, 0xB55), (0xC04, 0xC04),
    (0xC3C, 0xC3C), (0xC77, 0xC77), (0xC84, 0xC84), (0xD00, 0xD00), (0xD3B, 0xD3C),
    (0xD81, 0xD81), (0xEBA, 0xEBA), (0xECE, 0xECE), (0x166D, 0x166D), (0x1734, 0x1734),
    (0x180F, 0x180F), (0x1885, 0x1886), (0x1ABF, 0x1ACE), (0x1B7D, 0x1B7E),
    (0x1DF6, 0x1DFB), (0x2E43, 0x2E4F), (0x2E52, 0x2E5D), (0xA82C, 0xA82C),
    (0xA8C5, 0xA8C5), (0xA8FF, 0xA8FF), (0xA9BD, 0xA9BD), (0x10D24, 0x10D27),
    (0x10EAB, 0x10EAD), (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F55, 0x10F59),
    (0x10F82, 0x10F89), (0x11070, 0x11070), (0x11073, 0x11074), (0x110C2, 0x110C2),
    (0x110CD, 0x110CD), (0x111C9, 0x111C9), (0x111CF, 0x111CF), (0x1123E, 0x1123E),
    (0x11241, 0x11241), (0x1133B, 0x1133B), (0x11438, 0x1143F), (0x11442, 0x11444),
    (0x11446, 0x11446), (0x1144B, 0x1144F), (0x1145A, 0x1145B), (0x1145D, 0x1145E),
    (0x11660, 0x1166C), (0x116B9, 0x116B9), (0x1182F, 0x11837), (0x11839, 0x1183B),
    (0x1193B, 0x1193C), (0x1193E, 0x1193E), (0x11943, 0x11946), (0x119D4, 0x119D7),
    (0x119DA, 0x119DB), (0x119E0, 0x119E0), (0x119E2, 0x119E2), (0x11A01, 0x11A0A),
    (0x11A33, 0x11A38), (0x11A3B, 0x11A47), (0x11A51, 0x11A56), (0x11A59, 0x11A5B),
    (0x11A8A, 0x11A96), (0x11A98, 0x11A9C), (0x11A9E, 0x11AA2), (0x11B00, 0x11B09),
    (0x11C30, 0x11C36), (0x11C38, 0x11C3D), (0x11C3F, 0x11C3F), (0x11C41, 0x11C45),
    (0x11C70, 0x11C71), (0x11C92, 0x11CA7), (0x11CAA, 0x11CB0), (0x11CB2, 0x11CB3),
    (0x11CB5, 0x11CB6), (0x11D31, 0x11D36), (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D),
    (0x11D3F, 0x11D45), (0x11D47, 0x11D47), (0x11D90, 0x11D91), (0x11D95, 0x11D95),
    (0x11D97, 0x11D97), (0x11EF3, 0x11EF4), (0x11EF7, 0x11EF8), (0x11F00, 0x11F01),
    (0x11F36, 0x11F3A), (0x11F40, 0x11F40), (0x11F42, 0x11F4F), (0x11FFF, 0x11FFF),
    (0x12FF1, 0x12FF2), (0x13430, 0x13440), (0x13447, 0x13455), (0x16E97, 0x16E9A),
    (0x16F4F, 0x16F4F), (0x16FE2, 0x16FE2), (0x16FE4, 0x16FE4), (0x1CF00, 0x1CF2D),
    (0x1CF30, 0x1CF46), (0x1E000, 0x1E006), (0x1E008, 0x1E018), (0x1E01B, 0x1E021),
    (0x1E023, 0x1E024), (0x1E026, 0x1E02A), (0x1E08F, 0x1E08F), (0x1E130, 0x1E136),
    (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF), (0x1E944, 0x1E94A),
    (0x1E95E, 0x1E95F),
)
_UNKNOWN_STARTS = [lo for lo, _ in _UNKNOWN_TO_FAST]
# and three whose category those tables have otherwise
_FAST_CATEGORY = {0x166D: "Po", 0x1734: "Mn", 0x111C9: "Po"}
# Rust's `char::is_whitespace` (the Unicode White_Space property)
_WHITESPACE = frozenset(chr(c) for c in (
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B), 0x2028,
    0x2029, 0x202F, 0x205F, 0x3000))
# the same on ASCII text: controls dropped, tab and newlines made spaces;
# words and punctuation
_ASCII_CLEAN = {**{c: None for c in (*range(32), 127)}, 9: " ", 10: " ", 13: " "}
_ASCII_WORDS = re.compile(r"[^\s!-/:-@\[-`{-~]+|[!-/:-@\[-`{-~]")
# the fast decoder's per-token cleanup, then the Python side's on the string
_DECODE_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                   (" n't", "n't"), (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"),
                   (" 've", "'ve"), (" 're", "'re"))
_STRING_CLEANUP = tuple(p for p in _DECODE_CLEANUP if p[0] != " do not")


def _category(ch: str) -> str:
    """The character's general category as the fast tokenizer's tables
    have it ('Cn' for what they lack)."""
    cp = ord(ch)
    if cp in _FAST_CATEGORY:
        return _FAST_CATEGORY[cp]
    k = bisect.bisect_right(_UNKNOWN_STARTS, cp) - 1
    if k >= 0 and cp <= _UNKNOWN_TO_FAST[k][1]:
        return "Cn"
    return unicodedata.category(ch)


def _cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return _category(ch).startswith("P")


def normalize(text: str) -> str:
    """BertNormalizer(clean_text, handle_chinese_chars, strip_accents via
    lowercase, lowercase), step by step as the Rust normalizer runs it."""
    if text.isascii():
        return text.translate(_ASCII_CLEAN).lower()
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or (
                ch not in "\t\n\r" and _category(ch) in _DROPPED_CATEGORIES):
            continue
        if ch in _WHITESPACE:
            out.append(" ")
        elif _cjk(cp):
            out += (" ", ch, " ")
        else:
            out.append(ch)
    text = "".join(ch for ch in unicodedata.normalize("NFD", "".join(out))
                   if _category(ch) != "Mn")
    return "".join(ch.lower() for ch in text)


def pre_tokenize(text: str) -> list[str]:
    """Words at whitespace, every punctuation character a word of its own."""
    if text.isascii():
        return _ASCII_WORDS.findall(text)
    words = []
    for chunk in text.split():
        start = 0
        for i, ch in enumerate(chunk):
            if _punctuation(ch):
                if i > start:
                    words.append(chunk[start:i])
                words.append(ch)
                start = i + 1
        if start < len(chunk):
            words.append(chunk[start:])
    return words


class BertTokenizer:
    """WordPiece over a BERT `vocab.txt` (one token a line, the id its line
    number), with the attributes and calls of HF's tokenizer that the
    package uses."""

    max_input_chars_per_word = 100
    word_cache_size = 1 << 20  # words whose pieces are kept; emptied when full

    def __init__(self, vocab_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab = {t: i for i, t in enumerate(tokens)}
        self.ids_to_tokens = tokens
        for name, tok in zip(("pad", "unk", "cls", "sep", "mask"), SPECIAL_TOKENS):
            setattr(self, f"{name}_token", tok)
            setattr(self, f"{name}_token_id", self.vocab[tok])
        self.all_special_ids = [self.vocab[t] for t in SPECIAL_TOKENS]
        self._special_ids = frozenset(self.all_special_ids)
        self._word_cache: dict[str, tuple[str, ...]] = {}

    def __len__(self) -> int:
        return len(self.ids_to_tokens)

    def _wordpiece(self, word: str) -> tuple[str, ...]:
        pieces = self._word_cache.get(word)
        if pieces is not None:
            return pieces
        if len(word) > self.max_input_chars_per_word:
            pieces = (self.unk_token,)
        else:
            out, start = [], 0
            while start < len(word):
                end = len(word)
                while end > start:
                    piece = word[start:end] if start == 0 else "##" + word[start:end]
                    if piece in self.vocab:
                        break
                    end -= 1
                if end == start:
                    out = [self.unk_token]
                    break
                out.append(piece)
                start = end
            pieces = tuple(out)
        if len(self._word_cache) >= self.word_cache_size:
            self._word_cache.clear()
        self._word_cache[word] = pieces
        return pieces

    def tokenize(self, text: str) -> list[str]:
        """The tokens of `text`, without [CLS] and [SEP] around them."""
        tokens, start = [], 0
        for m in _SPECIAL_RE.finditer(text):
            for word in pre_tokenize(normalize(text[start:m.start()])):
                tokens += self._wordpiece(word)
            tokens.append(m.group())
            start = m.end()
        for word in pre_tokenize(normalize(text[start:])):
            tokens += self._wordpiece(word)
        return tokens

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        return [self.vocab[t] for t in tokens]

    def convert_ids_to_tokens(self, ids) -> list[str]:
        return [self.ids_to_tokens[int(i)] for i in ids]

    def encode(self, text: str, max_length: int) -> list[int]:
        """[CLS] ids [SEP], the ids truncated to fit `max_length`."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))[: max(max_length - 2, 0)]
        return [self.cls_token_id, *ids, self.sep_token_id]

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        """The fast tokenizer's decode: tokens joined by spaces, `##` pieces
        glued to the one before, each token's then the string's spaces
        before punctuation and contractions removed."""
        tokens = [t for i, t in zip(ids, self.convert_ids_to_tokens(ids))
                  if not (skip_special_tokens and int(i) in self._special_ids)]
        parts = []
        for k, tok in enumerate(tokens):
            if k:
                tok = tok[2:] if tok.startswith("##") else " " + tok
            for a, b in _DECODE_CLEANUP:
                tok = tok.replace(a, b)
            parts.append(tok)
        text = "".join(parts)
        for a, b in _STRING_CLEANUP:
            text = text.replace(a, b)
        return text


@lru_cache(maxsize=4)
def get_tokenizer(name: str = "bert-base-uncased",
                  resource_dir: str | None = None) -> BertTokenizer:
    """The tokenizer of `<resource_dir>/<name>/vocab.txt`, else the
    repository's `resource/<name>`; no download."""
    dirs = [os.path.join(root, name) for root in (resource_dir, DEFAULT_RESOURCE_DIR)
            if root is not None]
    for d in dirs:
        if os.path.isfile(os.path.join(d, "vocab.txt")):
            return BertTokenizer(os.path.join(d, "vocab.txt"))
    raise FileNotFoundError(f"no vocab.txt for tokenizer {name!r} under {dirs}")


def encode_texts(tokenizer: BertTokenizer, texts: list[str],
                 max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """(N, max_len) int32 ids and attention mask: [CLS] ... [SEP], truncated
    and padded with [PAD] to max_len (padding='max_length',
    truncation=True)."""
    ids = np.full((len(texts), max_len), tokenizer.pad_token_id, np.int32)
    mask = np.zeros((len(texts), max_len), np.int32)
    for r, text in enumerate(texts):
        row = tokenizer.encode(text, max_len)[:max_len]
        ids[r, : len(row)] = row
        mask[r, : len(row)] = 1
    return ids, mask


class MlmCollator:
    """MLM targets of rows of token ids, one call per sample as JAX's
    datasets call it. With `whole_word_masking` (HF's whole-word collator):
    candidate words are runs of a token and its `##` continuations, [CLS]
    and [SEP] excluded but [PAD] not; one shuffle of the candidates; whole
    words taken in that order up to round(L mlm_prob) tokens (at least 1,
    skipping words that overflow); the special and padding positions
    dropped; 80% of the rest [MASK], half of what remains random ids.
    Otherwise (HF's token-level collator) each non-special position is a
    target with probability mlm_prob, with the same 80 / 10 / 10 split."""

    mask_replace_prob = 0.8
    random_replace_prob = 0.1

    def __init__(self, tokenizer: BertTokenizer, whole_word_masking: bool = True,
                 mlm_prob: float = 0.15):
        self.tokenizer = tokenizer
        self.whole_word_masking = whole_word_masking
        self.mlm_prob = float(mlm_prob)
        self._local = threading.local()
        self._special = np.zeros(len(tokenizer), bool)
        self._special[tokenizer.all_special_ids] = True

    def _rngs(self, seed: int | None) -> tuple[random.Random, np.random.RandomState]:
        """This thread's generators, seeded with `seed` where it is given
        (re-seeding is ~100x cheaper than building a RandomState)."""
        state = self._local
        if not hasattr(state, "py"):
            state.py, state.np = random.Random(), np.random.RandomState()
        if seed is not None:
            state.py.seed(seed)
            state.np.seed(seed % (2 ** 32))
        return state.py, state.np

    def _word_mask(self, row: list[int], py_rng: random.Random) -> list[int]:
        tokens = self.tokenizer.convert_ids_to_tokens(row)
        cands: list[list[int]] = []
        for i, tok in enumerate(tokens):
            if tok in ("[CLS]", "[SEP]"):
                continue
            if cands and tok.startswith("##"):
                cands[-1].append(i)
            else:
                cands.append([i])
        py_rng.shuffle(cands)
        num_to_predict = min(512, max(1, int(round(len(tokens) * self.mlm_prob))))
        covered: list[int] = []
        for index_set in cands:
            if len(covered) >= num_to_predict:
                break
            if len(covered) + len(index_set) > num_to_predict:
                continue
            covered += index_set
        chosen = set(covered)
        return [1 if i in chosen else 0 for i in range(len(tokens))]

    def __call__(self, input_ids: np.ndarray,
                 seed: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(B, L) ids -> (int64 ids_mlm, int64 labels), labels -100 off the
        targets; `seed` gives the draws of JAX's collator under
        `random.seed(seed)` and `np.random.seed(seed % 2**32)`."""
        py_rng, np_rng = self._rngs(seed)
        inputs = np.array(np.asarray(input_ids), dtype=np.int64)
        labels = inputs.copy()
        special = self._special[inputs]
        if self.whole_word_masking:
            masked = np.array([self._word_mask(row, py_rng) for row in inputs.tolist()],
                              np.int64).astype(bool)
            masked[special] = False
            masked[inputs == self.tokenizer.pad_token_id] = False
        else:
            prob = np.full(inputs.shape, self.mlm_prob)
            prob[special] = 0
            masked = np_rng.binomial(1, prob, size=prob.shape).astype(bool)
        labels[~masked] = -100
        replaced = np_rng.binomial(1, self.mask_replace_prob,
                                   size=labels.shape).astype(bool) & masked
        inputs[replaced] = self.tokenizer.mask_token_id
        scaled = self.random_replace_prob / (1 - self.mask_replace_prob)
        random_pos = (np_rng.binomial(1, scaled, size=labels.shape).astype(bool)
                      & masked & ~replaced)
        n = len(self.tokenizer)
        if self.whole_word_masking:
            words = np_rng.randint(low=0, high=n, size=labels.shape, dtype=np.int64)
            inputs[random_pos] = words[random_pos]
        else:
            inputs[random_pos] = np_rng.randint(
                low=0, high=n, size=np.count_nonzero(random_pos), dtype=np.int64)
        return inputs, labels
