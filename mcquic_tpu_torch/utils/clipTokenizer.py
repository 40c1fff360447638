"""CLIP's byte-level BPE tokenizer, read from a model folder's `vocab.json`,
`merges.txt` and `tokenizer_config.json`, with no tokenizer library.

It gives the `input_ids` that the JAX package's caption encoder
(`mcquic_tpu/utils/textEncoder.py`) gets from `CLIPProcessor`, whose
tokenizer is `CLIPTokenizerFast` for a folder that ships `tokenizer.json`,
as the published one does. That tokenizer's pipeline, step by step:
  1. special tokens: the added tokens (`<|startoftext|>`, `<|endoftext|>`)
     are cut out of the text first, those marked `normalized` after step 2;
  2. normalizer: NFC, every run of white space to one space, then each
     character to lower case on its own (so a final sigma is not special);
  3. pre-tokenizer: the pieces matched by
     `'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+` (white
     space between them is dropped), each piece's UTF-8 bytes mapped to
     GPT-2's printable byte characters;
  4. BPE on each piece with `</w>` on its last character: the pair of least
     rank merges first, the leftmost among equals (tokenizers' `merge_all`);
  5. `<|startoftext|>` ... `<|endoftext|>` around the ids, after truncating
     them to `model_max_length` less those two;
  6. padding to the batch's longest with the pad token, on the right.

`re` has no `\\p{L}` or `\\p{N}`, so the classes come from
`unicodedata.category` (L* and N*), and white space is Unicode's White_Space
set, which is what the tokenizer's regex engine means by `\\s` (Python's
`str.isspace` also takes U+001C..U+001F).

Python's Unicode database (15.0 in Python 3.12) is not the tokenizer's, and
the three tables below carry the difference, found by running every code
point through tokenizers 0.22's normalizer and pre-tokenizer:
  * LATE_LETTERS, LATE_NUMBERS: code points unassigned in Python's database
    that the tokenizer's regex (Unicode 16) takes as \\p{L} or \\p{N};
  * LATE_LOWER: their lower-case mappings (Rust's, Unicode 16 and later);
  * NFC_BOUNDARIES: the tokenizer's NFC tables predate Unicode 11, so the
    combining marks added since are starters there (no canonical
    reordering across them), and U+11930 does not compose with U+11935.
    NFC runs on the text between them.
"""
import json
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

WHITE_SPACE = frozenset(map(chr, [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                                  0x2028, 0x2029, 0x202F, 0x205F, 0x3000]))
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _table(ranges):
    return frozenset(chr(c) for a, b in ranges for c in range(a, b + 1))


LATE_LETTERS = _table([
    (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3), (0x10D4A, 0x10D65),
    (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389), (0x1138B, 0x1138B),
    (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
    (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA), (0x16100, 0x1611D),
    (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0),
    (0x2EBF0, 0x2EE5D)])
LATE_NUMBERS = _table([
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139),
    (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA)])
LATE_LOWER = {chr(a): chr(b) for a, b in [
    (0x1C89, 0x1C8A), (0xA7CB, 0x264), (0xA7CC, 0xA7CD), (0xA7CE, 0xA7CF), (0xA7D2, 0xA7D3),
    (0xA7D4, 0xA7D5), (0xA7DA, 0xA7DB), (0xA7DC, 0x19B),
    *((c, c + 0x20) for c in range(0x10D50, 0x10D66)),
    *((c, c + 0x1B) for c in range(0x16EA0, 0x16EB9))]}
NFC_BOUNDARIES = _table([
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8D3), (0x9FE, 0x9FE), (0xC3C, 0xC3C),
    (0xD3B, 0xD3C), (0xEBA, 0xEBA), (0x1715, 0x1715), (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFA),
    (0xA82C, 0xA82C), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF),
    (0x10F46, 0x10F50), (0x10F82, 0x10F85), (0x11070, 0x11070), (0x1133B, 0x1133B),
    (0x1145E, 0x1145E), (0x11839, 0x1183A), (0x11930, 0x11930), (0x1193D, 0x1193E),
    (0x11943, 0x11943), (0x119E0, 0x119E0), (0x11A34, 0x11A34), (0x11A47, 0x11A47),
    (0x11A99, 0x11A99), (0x11D42, 0x11D42), (0x11D44, 0x11D45), (0x11D97, 0x11D97),
    (0x11F41, 0x11F42), (0x16FF0, 0x16FF1), (0x1E08F, 0x1E08F), (0x1E130, 0x1E136),
    (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF)])
MAX_MERGES = 49152 - 256 - 2     # the merges CLIPTokenizer reads (tokenization_clip.py)
SUFFIX = "</w>"
DEFAULT_SPECIALS = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                    "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}


def bytesToUnicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
            *range(ord("®"), ord("ÿ") + 1)]
    chars, extra = {}, 0
    for b in range(256):
        if b in keep:
            chars[b] = chr(b)
        else:
            chars[b] = chr(256 + extra)
            extra += 1
    return chars


BYTE_CHARS = bytesToUnicode()


def nfc(text: str) -> str:
    """The tokenizer's NFC: Python's between the NFC_BOUNDARIES."""
    out, start = [], 0
    for i, ch in enumerate(text):
        if ch in NFC_BOUNDARIES:
            out += [unicodedata.normalize("NFC", text[start:i]), ch]
            start = i + 1
    out.append(unicodedata.normalize("NFC", text[start:]))
    return "".join(out)


def normalize(text: str) -> str:
    """NFC, white-space runs to one space, each character to lower case."""
    out, space = [], False
    for ch in nfc(text):
        if ch in WHITE_SPACE:
            if not space:
                out.append(" ")
            space = True
        else:
            out.append(LATE_LOWER.get(ch) or ch.lower())
            space = False
    return "".join(out)


def _kind(ch: str) -> str:
    if ch in WHITE_SPACE:
        return "space"
    category = unicodedata.category(ch)[0]
    if category == "L" or ch in LATE_LETTERS:
        return "letter"
    if category == "N" or ch in LATE_NUMBERS:
        return "number"
    return "other"


def splitPieces(text: str) -> List[str]:
    """The pre-tokenizer's pieces of normalized text, in order."""
    pieces, i, n = [], 0, len(text)
    while i < n:
        if text[i] == "'":
            match = next((c for c in CONTRACTIONS if text.startswith(c, i)), None)
            if match:
                pieces.append(match)
                i += len(match)
                continue
        kind = _kind(text[i])
        if kind == "space":
            i += 1
            continue
        j = i + 1
        if kind != "number":                 # letters and others run; a number is one character
            while j < n and _kind(text[j]) == kind:
                j += 1
        pieces.append(text[i:j])
        i = j
    return pieces


def _content(entry):
    return entry["content"] if isinstance(entry, dict) else entry


class ClipTokenizer:
    """`ClipTokenizer(folder)(captions)` -> (input_ids, attention_mask), lists
    of equal-length int lists, as `CLIPProcessor(text=captions, padding=True,
    truncation=True)` gives them."""

    def __init__(self, folder):
        folder = Path(folder)
        self.vocab: Dict[str, int] = json.loads((folder / "vocab.json").read_text("utf-8"))
        lines = (folder / "merges.txt").read_text("utf-8").strip().split("\n")[1:MAX_MERGES + 1]
        self.ranks: Dict[Tuple[str, str], int] = {tuple(line.split()): r for r, line in enumerate(lines)}
        configPath = folder / "tokenizer_config.json"
        config = json.loads(configPath.read_text("utf-8")) if configPath.exists() else {}
        names = {key: _content(config.get(key, default)) for key, default in DEFAULT_SPECIALS.items()}
        # (content, normalized) of the added tokens, as the fast tokenizer keeps them
        added = config.get("added_tokens_decoder")
        if added:
            self.added = {entry["content"]: (int(i), bool(entry.get("normalized", False)))
                          for i, entry in added.items()}
        else:
            self.added = {}       # an older config's special tokens, the first entry of each content
            for key in DEFAULT_SPECIALS:
                entry = config.get(key, DEFAULT_SPECIALS[key])
                normalized = entry.get("normalized", False) if isinstance(entry, dict) else False
                self.added.setdefault(_content(entry), (self.vocab[_content(entry)], normalized))
        idOf = lambda name: self.added[name][0] if name in self.added else self.vocab[name]
        self.bosId, self.eosId = idOf(names["bos_token"]), idOf(names["eos_token"])
        self.unkId, self.padId = idOf(names["unk_token"]), idOf(names["pad_token"])
        self.maxLength: Optional[int] = config.get("model_max_length")
        if self.maxLength is not None and self.maxLength > 1 << 40:   # transformers' "no limit"
            self.maxLength = None

    def _splitAdded(self, text: str, normalized: bool) -> List[Tuple[str, Optional[int]]]:
        """Text cut at the added tokens of one kind, leftmost and longest first:
        [(text, None) or (token, id)]."""
        tokens = sorted((c for c, (_, norm) in self.added.items() if norm == normalized),
                        key=len, reverse=True)
        out, start, i = [], 0, 0
        while tokens and i < len(text):
            hit = next((t for t in tokens if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if i > start:
                out.append((text[start:i], None))
            out.append((hit, self.added[hit][0]))
            i = start = i + len(hit)
        if start < len(text):
            out.append((text[start:], None))
        return out

    def bpe(self, piece: str) -> List[int]:
        """The ids of one pre-tokenized piece (its byte characters)."""
        symbols = list(piece)
        symbols[-1] += SUFFIX
        while len(symbols) > 1:
            best = min(((self.ranks[pair], i) for i, pair in enumerate(zip(symbols, symbols[1:]))
                        if pair in self.ranks), default=None)
            if best is None:
                break
            i = best[1]
            symbols[i:i + 2] = [symbols[i] + symbols[i + 1]]
        return [self.vocab.get(s, self.unkId) for s in symbols]

    def encode(self, text: str) -> List[int]:
        """The ids of one caption, without the start and end tokens."""
        ids = []
        for part, special in self._splitAdded(text, False):
            if special is not None:
                ids.append(special)
                continue
            for sub, special2 in self._splitAdded(normalize(part), True):
                if special2 is not None:
                    ids.append(special2)
                    continue
                for piece in splitPieces(sub):
                    ids.extend(self.bpe("".join(BYTE_CHARS[b] for b in piece.encode("utf-8"))))
        return ids

    def __call__(self, captions: Sequence[str]) -> Tuple[List[List[int]], List[List[int]]]:
        rows = []
        for text in captions:
            ids = self.encode(text)
            if self.maxLength is not None:
                ids = ids[:max(self.maxLength - 2, 0)]
            rows.append([self.bosId, *ids, self.eosId])
        width = max(len(r) for r in rows)
        return ([r + [self.padId] * (width - len(r)) for r in rows],
                [[1] * len(r) + [0] * (width - len(r)) for r in rows])


def learnMerges(corpus: Sequence[str], count: int) -> List[Tuple[str, str]]:
    """`count` BPE merges learned from `corpus` by the usual greedy rule (the
    most frequent adjacent pair, the first seen among equals), over the
    tokenizer's own pieces: a small vocabulary for seeded folders."""
    words: Dict[Tuple[str, ...], int] = {}
    for text in corpus:
        for piece in splitPieces(normalize(text)):
            symbols = [BYTE_CHARS[b] for b in piece.encode("utf-8")]
            symbols[-1] += SUFFIX
            words[tuple(symbols)] = words.get(tuple(symbols), 0) + 1
    merges = []
    for _ in range(count):
        pairs: Dict[Tuple[str, str], int] = {}
        for word, n in words.items():
            for pair in zip(word, word[1:]):
                pairs[pair] = pairs.get(pair, 0) + n
        if not pairs:
            break
        pair = max(pairs, key=pairs.get)
        merges.append(pair)
        merged = {}
        for word, n in words.items():
            out, i = [], 0
            while i < len(word):
                if word[i:i + 2] == pair:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + n
        words = merged
    return merges


def writeByteLevelVocab(folder, corpus: Sequence[str], merges: int, vocabSize: int = None,
                        maxLength: int = 77) -> Dict[str, int]:
    """Write `vocab.json`, `merges.txt` and `tokenizer_config.json` of a
    byte-level CLIP vocabulary laid out as the published one: the 256 byte
    characters, the same with `</w>`, the merges learned from `corpus`, then
    `<|startoftext|>` and `<|endoftext|>`, which take the last two ids of
    `vocabSize` where it is given (the ids between are unused). Returns the
    vocabulary."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    pairs = learnMerges(corpus, merges)
    tokens = list(BYTE_CHARS.values())
    tokens += [c + SUFFIX for c in BYTE_CHARS.values()] + [a + b for a, b in pairs]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    first = len(vocab) if vocabSize is None else vocabSize - 2
    if first < len(vocab):
        raise ValueError(f"vocabSize {vocabSize} leaves no room for {len(vocab)} tokens and 2 specials")
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = first, first + 1
    (folder / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), "utf-8")
    (folder / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in pairs),
                                       "utf-8")
    config = {**DEFAULT_SPECIALS, "model_max_length": maxLength, "tokenizer_class": "CLIPTokenizer"}
    (folder / "tokenizer_config.json").write_text(json.dumps(config), "utf-8")
    return vocab
