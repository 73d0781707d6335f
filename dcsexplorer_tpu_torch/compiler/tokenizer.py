"""Script tokenizer: C-like lexer with locations and an error logger.

Counterpart of the reference's DCSTokenizer (DCSTokenizer.{h,cpp}): symbols,
ints ($hex / 0x / decimal), floats, strings, punctuation, ``//`` comments,
case-insensitive keywords, and Info/Warning/Error levels with file(line)
locations.

The port's copy of ``dcsexplorer_tpu/compiler/tokenizer.py``.
"""

from dataclasses import dataclass, field


@dataclass
class Token:
    kind: str       # 'sym', 'int', 'float', 'str', 'punct', 'eof'
    text: str
    value: object
    line: int


@dataclass
class ErrorLogger:
    filename: str = "<script>"
    messages: list = field(default_factory=list)
    n_errors: int = 0
    n_warnings: int = 0

    def error(self, line, msg):
        self.n_errors += 1
        self.messages.append(f"{self.filename}({line}): error: {msg}")

    def warning(self, line, msg):
        self.n_warnings += 1
        self.messages.append(f"{self.filename}({line}): warning: {msg}")

    def info(self, line, msg):
        self.messages.append(f"{self.filename}({line}): {msg}")


PUNCT = ("(", ")", "{", "}", "[", "]", ",", ";", ":", "=", "*", "-", "+")


def tokenize(text, log: ErrorLogger):
    toks = []
    i, n, line = 0, len(text), 1
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
        elif c in " \t\r":
            i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
        elif c == '"':
            j = i + 1
            out = []
            while j < n and text[j] != '"':
                if text[j] == "\n":
                    break
                out.append(text[j])
                j += 1
            if j >= n or text[j] != '"':
                log.error(line, "unterminated string")
            toks.append(Token("str", "".join(out), "".join(out), line))
            i = j + 1
        elif c == "$":
            j = i + 1
            while j < n and text[j] in "0123456789abcdefABCDEF":
                j += 1
            if j == i + 1:
                log.error(line, "expected hex digits after '$'")
                i = j
                continue
            toks.append(Token("int", text[i:j], int(text[i + 1:j], 16), line))
            i = j
        elif c.isdigit():
            j = i
            if text[i:i + 2].lower() == "0x":
                j = i + 2
                while j < n and text[j] in "0123456789abcdefABCDEF":
                    j += 1
                toks.append(Token("int", text[i:j], int(text[i + 2:j], 16), line))
            else:
                is_float = False
                while j < n and (text[j].isdigit() or text[j] in ".eE"
                                 or (text[j] in "+-" and text[j - 1] in "eE")):
                    if text[j] in ".eE":
                        is_float = True
                    j += 1
                t = text[i:j]
                if is_float:
                    toks.append(Token("float", t, float(t), line))
                else:
                    toks.append(Token("int", t, int(t), line))
            i = j
        elif c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            t = text[i:j]
            toks.append(Token("sym", t, t.lower(), line))
            i = j
        elif c in PUNCT:
            toks.append(Token("punct", c, c, line))
            i += 1
        else:
            log.error(line, f"unexpected character {c!r}")
            i += 1
    toks.append(Token("eof", "", None, line))
    return toks


class TokenStream:
    def __init__(self, toks, log):
        self.toks = toks
        self.pos = 0
        self.log = log

    @property
    def cur(self):
        return self.toks[self.pos]

    def next(self):
        t = self.toks[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def peek_is(self, kind, value=None):
        t = self.cur
        return t.kind == kind and (value is None or t.value == value)

    def accept(self, kind, value=None):
        if self.peek_is(kind, value):
            return self.next()
        return None

    def expect(self, kind, value=None, what=None):
        t = self.cur
        if self.peek_is(kind, value):
            return self.next()
        self.log.error(t.line,
                       f"expected {what or value or kind}, found {t.text!r}")
        return None

    def resync(self):
        """Skip to the next ';' or '}' for statement-level error recovery."""
        while not self.peek_is("eof"):
            t = self.next()
            if t.kind == "punct" and t.value in (";", "}"):
                return
