"""A reader for the YAML subset of the repository's configs (`configs/**/*.yaml`),
giving the values `yaml.full_load` gives, without the `yaml` package.

It takes block mappings, block sequences (of scalars, flow collections or
mappings), flow mappings and flow lists (on one line or across lines),
comments, single- and double-quoted strings, and plain scalars, resolved by
PyYAML's YAML 1.1 rules: null (`~`, `null`, empty), booleans (`true`,
`yes`, `on`, ... in their three cases), ints (decimal, `0x`, `0o`/leading-0
octal, `_` separators) and floats (a dot is required: `1.e-4` and `1.0e-4`
are floats, `1e-4` is the string PyYAML makes of it). Anchors, aliases,
tags, block scalars (`|`, `>`), base-60 numbers (`1:30`) and
multi-document files are refused.
"""
import re
from typing import Any, List, Tuple

_BOOL = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9_]+(?:[eE][-+][0-9]+)?
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN))$""", re.X)
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+)$")


class YamlError(ValueError):
    pass


def resolvePlain(text: str) -> Any:
    """A plain scalar's value under PyYAML's implicit resolvers."""
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if _SEXAGESIMAL.match(text):
        raise YamlError(f"base-60 numbers are not supported: {text}")
    if text.lower() in _BOOL and text in (text.lower(), text.upper(), text.capitalize()):
        return _BOOL[text.lower()]
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value != "0" and value.startswith("0"):
            return sign * int(value, 8)
        return sign * int(value)
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        if value.endswith(("inf", "nan")):
            return float(value.replace(".", ""))
        return float(value)
    return text


def _stripComment(line: str) -> str:
    """The line without its comment: a # at the start or after whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted string starting at text[i]; returns (value, index past it)."""
    q, out, i = text[i], [], i + 1
    escapes = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0", "r": "\r"}
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            if text[i + 1] not in escapes:
                raise YamlError(f"unsupported escape \\{text[i + 1]}")
            out.append(escapes[text[i + 1]])
            i += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    raise YamlError(f"unterminated string: {text}")


class _Flow:
    """A recursive-descent reader of one flow collection."""

    def __init__(self, text: str):
        self.text, self.i = text, 0

    def skip(self):
        while self.i < len(self.text) and self.text[self.i] in " \t\n":
            self.i += 1

    def value(self) -> Any:
        self.skip()
        ch = self.text[self.i]
        if ch == "{":
            return self.collection("}", mapping=True)
        if ch == "[":
            return self.collection("]", mapping=False)
        if ch in "'\"":
            value, self.i = _quoted(self.text, self.i)
            return value
        start = self.i
        while self.i < len(self.text):
            ch = self.text[self.i]
            if ch in ",]}" or (ch == ":" and self.text[self.i + 1:self.i + 2] in (" ", "")):
                break
            self.i += 1
        return resolvePlain(self.text[start:self.i].strip())

    def collection(self, close: str, mapping: bool):
        self.i += 1
        out = {} if mapping else []
        while True:
            self.skip()
            if self.text[self.i] == close:
                self.i += 1
                return out
            item = self.value()
            self.skip()
            if mapping:
                if self.text[self.i] != ":":
                    raise YamlError(f"expected ':' in flow mapping: {self.text}")
                self.i += 1
                out[item] = self.value()
                self.skip()
            else:
                out.append(item)
            if self.text[self.i] == ",":
                self.i += 1
            elif self.text[self.i] != close:
                raise YamlError(f"expected ',' or {close!r}: {self.text}")


def _scalarOrFlow(text: str) -> Any:
    if text[:1] in "{[":
        reader = _Flow(text)
        value = reader.value()
        if reader.text[reader.i:].strip():
            raise YamlError(f"text after a flow collection: {text}")
        return value
    if text[:1] in "'\"":
        value, end = _quoted(text, 0)
        if text[end:].strip():
            raise YamlError(f"text after a quoted scalar: {text}")
        return value
    if text[:1] in "&*!|>%@`":
        raise YamlError(f"unsupported YAML construct: {text}")
    return resolvePlain(text)


def _splitKey(text: str):
    """'key: value' -> (key, value text), or None when text is no mapping entry."""
    if text[:1] in "'\"":
        key, end = _quoted(text, 0)
        rest = text[end:].lstrip()
        return (key, rest[1:].strip()) if rest.startswith(":") else None
    if text[:1] in "{[":
        return None
    m = re.search(r":(\s|$)", text)
    if m is None:
        return None
    return resolvePlain(text[:m.start()].strip()), text[m.end():].strip()


class _Block:
    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines, self.i = lines, 0

    def flowText(self, text: str) -> str:
        """A flow collection's text, joined with the lines that continue it."""
        depth = lambda t: sum(t.count(c) for c in "[{") - sum(t.count(c) for c in "]}")
        while depth(text) > 0 and self.i < len(self.lines):
            text += " " + self.lines[self.i][1]
            self.i += 1
        return text

    def value(self, text: str, indent: int) -> Any:
        """The value after 'key:' or '- ': inline text, or the block below."""
        if text:
            return _scalarOrFlow(self.flowText(text))
        if self.i < len(self.lines):
            nextIndent, nextText = self.lines[self.i]
            if nextIndent > indent or (nextIndent == indent and nextText.startswith("- ")):
                return self.block(nextIndent)
        return None

    def block(self, indent: int) -> Any:
        if self.lines[self.i][1] == "-" or self.lines[self.i][1].startswith("- "):
            return self.sequence(indent)
        return self.mapping(indent)

    def mapping(self, indent: int, first: str = None) -> dict:
        out = {}
        while self.i < len(self.lines) or first is not None:
            if first is None:
                lineIndent, text = self.lines[self.i]
                if lineIndent < indent or (lineIndent == indent and text.startswith("- ")):
                    break
                if lineIndent > indent:
                    raise YamlError(f"bad indentation: {text}")
                self.i += 1
            else:
                text, first = first, None
            entry = _splitKey(text)
            if entry is None:
                raise YamlError(f"expected 'key: value': {text}")
            key, rest = entry
            if key in out:
                raise YamlError(f"duplicate key {key!r}")
            out[key] = self.value(rest, indent)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            lineIndent, text = self.lines[self.i]
            if lineIndent != indent or not (text == "-" or text.startswith("- ")):
                if lineIndent > indent:
                    raise YamlError(f"bad indentation: {text}")
                break
            self.i += 1
            item = text[1:].strip()
            itemIndent = indent + len(text) - len(text[1:].lstrip()) if item else indent
            if item == "-" or item.startswith("- "):      # a sequence in a sequence
                self.i -= 1
                self.lines[self.i] = (itemIndent, item)
                out.append(self.sequence(itemIndent))
            elif item and item[:1] not in "{['\"" and _splitKey(item) is not None:
                out.append(self.mapping(itemIndent, first=item))
            else:
                out.append(self.value(item, indent))
        return out


def loads(text: str) -> Any:
    """The value of a YAML document in the subset above."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlError("tabs in indentation")
        line = _stripComment(raw)
        if line.strip() in ("---", "..."):
            raise YamlError("document markers are not supported")
        if line.strip():
            lines.append((len(line) - len(line.lstrip()), line.strip()))
    if not lines:
        return None
    reader = _Block(lines)
    value = reader.block(lines[0][0])
    if reader.i != len(lines):
        raise YamlError(f"unexpected text: {lines[reader.i][1]}")
    return value


def load(path) -> Any:
    with open(path) as fp:
        return loads(fp.read())
