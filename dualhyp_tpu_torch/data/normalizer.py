"""Whisper-protocol English text normalisation (full capability).

The reference normalises every hypothesis and caption with the upstream
whisper `EnglishTextNormalizer` (spelled-out numbers -> digits, contraction
and title expansion, symbol/diacritic removal, British->American spelling)
and then converts the resulting digits BACK to spelled-out words with
num2words, mapping '%' to ' percent'
(ref: data/make_json_asr.py:13-14, 244-252;
 data/whisper/normalizers/english.py:1-550, basic.py:1-76).

This module reimplements that capability in one place:

  * ``remove_symbols_and_diacritics`` / ``remove_symbols`` /
    ``BasicTextNormalizer``  (ref: data/whisper/normalizers/basic.py)
  * ``EnglishNumberNormalizer``  — spelled-out numbers -> arabic digits with
    currency/ordinal/plural/decimal handling
    (ref: data/whisper/normalizers/english.py:13-449)
  * ``EnglishSpellingNormalizer`` — British->American word mapping. NOTE:
    the reference repo is missing its ``english.json`` asset (its class
    raises FileNotFoundError); we ship a generated table covering the
    common tysto.com UK->US families and accept a custom mapping
    (ref: data/whisper/normalizers/english.py:451-462)
  * ``EnglishTextNormalizer``  — the composed pipeline
    (ref: data/whisper/normalizers/english.py:465-550)
  * ``number_to_words``        — num2words('en') cardinal equivalent
  * ``HypothesisNormalizer``   — the end-to-end reference ``normalize()``
    (ref: data/make_json_asr.py:244-252)

Differential-tested against the reference implementation in
tests/test_normalizer_full.py.

A copy of `dualhyp_tpu/data/normalizer.py` (which imports no JAX), kept in
the port so that it imports nothing of the JAX package; held against it in
tests/test_torch_asr_cli.py.
"""

from __future__ import annotations

import re
import unicodedata
from decimal import Decimal
from fractions import Fraction
from typing import Dict, Iterable, List, Optional


# ---------------------------------------------------------------------------
# basic.py parity
# ---------------------------------------------------------------------------

# non-ASCII letters that NFKD does not decompose
_EXTRA_DIACRITICS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Drop diacritics; replace markers/symbols/punctuation with a space."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in _EXTRA_DIACRITICS:
            out.append(_EXTRA_DIACRITICS[c])
        elif unicodedata.category(c) == "Mn":
            pass
        elif unicodedata.category(c)[0] in "MSP":
            out.append(" ")
        else:
            out.append(c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """Replace markers/symbols/punctuation with a space, keep diacritics."""
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s)
    )


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = (
            remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        )
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = self.clean(s).lower()
        if self.split_letters:
            try:
                import regex

                s = " ".join(regex.findall(r"\X", s, regex.U))
            except ImportError:  # grapheme clusters ~= characters for our data
                s = " ".join(s)
        s = re.sub(r"\s+", " ", s)
        return s


# ---------------------------------------------------------------------------
# spelled-out numbers -> arabic digits
# ---------------------------------------------------------------------------

_ONES_WORDS = [
    "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
]
_TENS_WORDS = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}
_MULTIPLIER_WORDS = {
    "hundred": 10**2, "thousand": 10**3, "million": 10**6, "billion": 10**9,
    "trillion": 10**12, "quadrillion": 10**15, "quintillion": 10**18,
    "sextillion": 10**21, "septillion": 10**24, "octillion": 10**27,
    "nonillion": 10**30, "decillion": 10**33,
}

_NUMERIC_RE = re.compile(r"^\d+(\.\d+)?$")


class EnglishNumberNormalizer:
    """Spelled-out numbers -> digits, keeping suffixes (1960s, 274th, 32nd),
    currency symbols ($20 million -> $20000000), 'one oh one' -> 101, etc.
    (ref: data/whisper/normalizers/english.py:13-449)."""

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        self.ones = {w: i + 1 for i, w in enumerate(_ONES_WORDS)}
        self.ones_plural = {
            ("sixes" if w == "six" else w + "s"): (v, "s")
            for w, v in self.ones.items()
        }
        self.ones_ordinal = {
            "zeroth": (0, "th"), "first": (1, "st"), "second": (2, "nd"),
            "third": (3, "rd"), "fifth": (5, "th"), "twelfth": (12, "th"),
        }
        for w, v in self.ones.items():
            if v > 3 and v not in (5, 12):
                self.ones_ordinal[w + ("h" if w.endswith("t") else "th")] = (v, "th")
        self.ones_suffixed = {**self.ones_plural, **self.ones_ordinal}

        self.tens = dict(_TENS_WORDS)
        self.tens_plural = {
            w.replace("y", "ies"): (v, "s") for w, v in self.tens.items()
        }
        self.tens_ordinal = {
            w.replace("y", "ieth"): (v, "th") for w, v in self.tens.items()
        }
        self.tens_suffixed = {**self.tens_plural, **self.tens_ordinal}

        self.multipliers = dict(_MULTIPLIER_WORDS)
        self.multipliers_suffixed = {}
        for w, v in self.multipliers.items():
            self.multipliers_suffixed[w + "s"] = (v, "s")
            self.multipliers_suffixed[w + "th"] = (v, "th")

        self.decimals = set(self.ones) | set(self.tens) | self.zeros

        self.preceding_prefixers = {
            "minus": "-", "negative": "-", "plus": "+", "positive": "+",
        }
        self.following_prefixers = {
            "pound": "£", "pounds": "£", "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢",
        }
        self.prefixes = set(self.preceding_prefixers.values()) | set(
            self.following_prefixers.values()
        )
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}

        self.words = set()
        for table in (
            self.zeros, self.ones, self.ones_suffixed, self.tens,
            self.tens_suffixed, self.multipliers, self.multipliers_suffixed,
            self.preceding_prefixers, self.following_prefixers,
            self.suffixers, self.specials,
        ):
            self.words.update(table)
        self.literal_words = {"one", "ones"}

    # -- the token-stream parser --------------------------------------------

    def process_words(self, words: List[str]) -> Iterable[str]:
        out: List[str] = []
        state = {"value": None, "prefix": None}

        def emit(result):
            r = str(result)
            if state["prefix"] is not None:
                r = state["prefix"] + r
            state["value"] = None
            state["prefix"] = None
            out.append(r)

        n = len(words)
        i = 0
        while i < n:
            prev = words[i - 1] if i > 0 else None
            cur = words[i]
            nxt = words[i + 1] if i + 1 < n else None
            i += 1

            value = state["value"]
            next_is_numeric = nxt is not None and _NUMERIC_RE.match(nxt)
            has_prefix = cur[0] in self.prefixes
            cur_core = cur[1:] if has_prefix else cur

            if _NUMERIC_RE.match(cur_core):
                # arabic numbers (potentially signed / decimal)
                f = Fraction(cur_core)
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        # decimal / ip-address continuation
                        state["value"] = str(value) + str(cur)
                        continue
                    emit(value)
                if has_prefix:
                    state["prefix"] = cur[0]
                state["value"] = f.numerator if f.denominator == 1 else cur_core
            elif cur not in self.words:
                if value is not None:
                    emit(value)
                emit(cur)
            elif cur in self.zeros:
                state["value"] = str(value or "") + "0"
            elif cur in self.ones:
                ones = self.ones[cur]
                if value is None:
                    state["value"] = ones
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        # replace the trailing zero with the digit
                        assert value[-1] == "0"
                        state["value"] = value[:-1] + str(ones)
                    else:
                        state["value"] = str(value) + str(ones)
                elif ones < 10:
                    if value % 10 == 0:
                        state["value"] = value + ones
                    else:
                        state["value"] = str(value) + str(ones)
                else:  # eleven..nineteen
                    if value % 100 == 0:
                        state["value"] = value + ones
                    else:
                        state["value"] = str(value) + str(ones)
            elif cur in self.ones_suffixed:
                ones, suffix = self.ones_suffixed[cur]
                if value is None:
                    emit(str(ones) + suffix)
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        assert value[-1] == "0"
                        emit(value[:-1] + str(ones) + suffix)
                    else:
                        emit(str(value) + str(ones) + suffix)
                elif ones < 10:
                    if value % 10 == 0:
                        emit(str(value + ones) + suffix)
                    else:
                        emit(str(value) + str(ones) + suffix)
                else:
                    if value % 100 == 0:
                        emit(str(value + ones) + suffix)
                    else:
                        emit(str(value) + str(ones) + suffix)
                state["value"] = None
            elif cur in self.tens:
                tens = self.tens[cur]
                if value is None:
                    state["value"] = tens
                elif isinstance(value, str):
                    state["value"] = str(value) + str(tens)
                elif value % 100 == 0:
                    state["value"] = value + tens
                else:
                    state["value"] = str(value) + str(tens)
            elif cur in self.tens_suffixed:
                tens, suffix = self.tens_suffixed[cur]
                if value is None:
                    emit(str(tens) + suffix)
                elif isinstance(value, str):
                    emit(str(value) + str(tens) + suffix)
                elif value % 100 == 0:
                    emit(str(value + tens) + suffix)
                else:
                    emit(str(value) + str(tens) + suffix)
            elif cur in self.multipliers:
                multiplier = self.multipliers[cur]
                if value is None:
                    state["value"] = multiplier
                elif isinstance(value, str) or value == 0:
                    try:
                        f = Fraction(value)
                    except ValueError:
                        f = None
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        state["value"] = p.numerator
                    else:
                        emit(value)
                        state["value"] = multiplier
                else:
                    before = value // 1000 * 1000
                    residual = value % 1000
                    state["value"] = before + residual * multiplier
            elif cur in self.multipliers_suffixed:
                multiplier, suffix = self.multipliers_suffixed[cur]
                if value is None:
                    emit(str(multiplier) + suffix)
                elif isinstance(value, str):
                    try:
                        f = Fraction(value)
                    except ValueError:
                        f = None
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        emit(str(p.numerator) + suffix)
                    else:
                        emit(value)
                        emit(str(multiplier) + suffix)
                else:
                    before = value // 1000 * 1000
                    residual = value % 1000
                    emit(str(before + residual * multiplier) + suffix)
                state["value"] = None
            elif cur in self.preceding_prefixers:
                if value is not None:
                    emit(value)
                if (nxt in self.words) or next_is_numeric:
                    state["prefix"] = self.preceding_prefixers[cur]
                else:
                    emit(cur)
            elif cur in self.following_prefixers:
                if value is not None:
                    state["prefix"] = self.following_prefixers[cur]
                    emit(value)
                else:
                    emit(cur)
            elif cur in self.suffixers:
                if value is not None:
                    suffix = self.suffixers[cur]
                    if isinstance(suffix, dict):
                        if nxt in suffix:
                            emit(str(value) + suffix[nxt])
                            i += 1  # consume nxt
                        else:
                            emit(value)
                            emit(cur)
                    else:
                        emit(str(value) + suffix)
                else:
                    emit(cur)
            elif cur in self.specials:
                if (nxt not in self.words) and not next_is_numeric:
                    if value is not None:
                        emit(value)
                    emit(cur)
                elif cur == "and":
                    # drop "and" after hundreds/thousands/...
                    if prev not in self.multipliers:
                        if value is not None:
                            emit(value)
                        emit(cur)
                elif cur in ("double", "triple"):
                    if nxt in self.ones or nxt in self.zeros:
                        repeats = 2 if cur == "double" else 3
                        ones = self.ones.get(nxt, 0)
                        state["value"] = str(value or "") + str(ones) * repeats
                        i += 1  # consume nxt
                    else:
                        if value is not None:
                            emit(value)
                        emit(cur)
                elif cur == "point":
                    if nxt in self.decimals or next_is_numeric:
                        state["value"] = str(value or "") + "."
            else:  # pragma: no cover - tables above are exhaustive
                raise ValueError(f"Unexpected token: {cur}")

        if state["value"] is not None:
            emit(state["value"])
        return out

    # -- pre/post ------------------------------------------------------------

    def preprocess(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five"
        pieces = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if not segment.strip():
                continue
            pieces.append(segment)
            if i < len(segments) - 1:
                last_word = segment.rsplit(maxsplit=2)[-1]
                if last_word in self.decimals or last_word in self.multipliers:
                    pieces.append("point five")
                else:
                    pieces.append("and a half")
        s = " ".join(pieces)

        # space at number/letter boundary, then re-join ordinal suffixes
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def postprocess(self, s: str) -> str:
        def combine_cents(m):
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:
                return m.string

        def extract_cents(m):
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        # "$2 and ¢7" -> "$2.07"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)
        # keep "one(s)" spelled out
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(w for w in self.process_words(s.split()) if w is not None)
        return self.postprocess(s)


# ---------------------------------------------------------------------------
# British -> American spelling
# ---------------------------------------------------------------------------

def _build_uk_us_mapping() -> Dict[str, str]:
    """Generated UK->US table (tysto.com families). The reference's own
    english.json asset is absent from its repo; this is our equivalent data.
    """
    m: Dict[str, str] = {}

    # -our -> -or (with common derived forms)
    for base in (
        "arbour armour behaviour candour clamour colour demeanour endeavour "
        "favour fervour flavour glamour harbour honour humour labour "
        "neighbour odour parlour rancour rigour rumour saviour savour "
        "splendour succour tumour valour vapour vigour"
    ).split():
        us = base.replace("our", "or")
        m[base] = us
        m[base + "s"] = us + "s"
        m[base + "ed"] = us + "ed"
        m[base + "ing"] = us + "ing"
    for uk, us in {
        "favourite": "favorite", "favourites": "favorites",
        "favourable": "favorable", "favourably": "favorably",
        "honourable": "honorable", "honourably": "honorably",
        "behavioural": "behavioral", "neighbourhood": "neighborhood",
        "neighbourhoods": "neighborhoods", "neighbouring": "neighboring",
        "labourer": "laborer", "labourers": "laborers",
        "colourful": "colorful", "colourless": "colorless",
        "coloured": "colored", "colouring": "coloring",
        "humourous": "humorous", "glamourous": "glamorous",
    }.items():
        m[uk] = us

    # -ise -> -ize verb family (safe subset; advise/surprise etc. excluded)
    for base in (
        "apologise authorise capitalise categorise centralise characterise "
        "civilise colonise criticise customise dramatise emphasise energise "
        "equalise familiarise fantasise fertilise finalise formalise "
        "generalise harmonise hospitalise hypnotise idealise immunise "
        "improvise itemise jeopardise legalise localise magnetise maximise "
        "memorise mesmerise minimise mobilise modernise monopolise "
        "neutralise normalise organise patronise penalise personalise "
        "philosophise plagiarise polarise popularise prioritise privatise "
        "publicise rationalise realise recognise revolutionise satirise "
        "scrutinise sensitise socialise specialise stabilise standardise "
        "sterilise stigmatise subsidise summarise symbolise sympathise "
        "synchronise synthesise terrorise theorise traumatise utilise "
        "vandalise vaporise victimise visualise vocalise westernise"
    ).split():
        if base == "improvise":  # improvise is already US spelling
            continue
        us = base[:-3] + "ize"
        m[base] = us
        m[base + "s"] = us + "s"
        m[base + "d"] = us + "d"
        m[base[:-1] + "ing"] = us[:-1] + "ing"
        m[base[:-1] + "ation"] = us[:-1] + "ation"
        m[base[:-1] + "ations"] = us[:-1] + "ations"
        m[base + "r"] = us + "r"
        m[base + "rs"] = us + "rs"

    # -yse -> -yze
    for base in "analyse breathalyse catalyse electrolyse paralyse".split():
        us = base[:-3] + "yze"
        m[base] = us
        m[base + "s"] = us + "s"
        m[base + "d"] = us + "d"
        m[base[:-1] + "ing"] = us[:-1] + "ing"

    # -re -> -er
    for uk, us in {
        "centre": "center", "centres": "centers", "centred": "centered",
        "theatre": "theater", "theatres": "theaters",
        "metre": "meter", "metres": "meters",
        "kilometre": "kilometer", "kilometres": "kilometers",
        "centimetre": "centimeter", "centimetres": "centimeters",
        "millimetre": "millimeter", "millimetres": "millimeters",
        "litre": "liter", "litres": "liters",
        "fibre": "fiber", "fibres": "fibers",
        "calibre": "caliber", "lustre": "luster", "sombre": "somber",
        "spectre": "specter", "sceptre": "scepter", "sabre": "saber",
        "meagre": "meager", "mitre": "miter", "louvre": "louver",
        "manoeuvre": "maneuver", "manoeuvres": "maneuvers",
        "manoeuvred": "maneuvered", "manoeuvring": "maneuvering",
    }.items():
        m[uk] = us

    # doubled-l inflections -> single l
    for stem in (
        "travel cancel label model marvel jewel counsel fuel level quarrel "
        "signal total tunnel channel equal rival shovel snorkel grovel "
        "chisel dial duel enamel funnel gambol initial kennel libel panel "
        "parcel pedal pencil spiral squirrel stencil swivel"
    ).split():
        for suf_uk, suf_us in (("led", "ed"), ("ling", "ing"), ("ler", "er"),
                               ("lers", "ers"), ("lled", "led"),
                               ("lling", "ling"), ("ller", "ler"),
                               ("llers", "lers")):
            pass  # handled explicitly below for clarity
        m[stem + "led"] = stem + "ed"
        m[stem + "ling"] = stem + "ing"
        m[stem + "ler"] = stem + "er"
        m[stem + "lers"] = stem + "ers"
    for uk, us in {
        "marvellous": "marvelous", "jewellery": "jewelry",
        "counsellor": "counselor", "counsellors": "counselors",
        "woollen": "woolen", "chilli": "chili",
        "enrol": "enroll", "enrolment": "enrollment",
        "instalment": "installment", "instalments": "installments",
        "fulfil": "fulfill", "fulfilment": "fulfillment",
        "skilful": "skillful", "wilful": "willful",
        "appal": "appall", "distil": "distill", "instil": "instill",
    }.items():
        m[uk] = us

    # ae/oe -> e
    for uk, us in {
        "anaemia": "anemia", "anaemic": "anemic",
        "anaesthesia": "anesthesia", "anaesthetic": "anesthetic",
        "archaeology": "archeology", "archaeological": "archeological",
        "archaeologist": "archeologist", "archaeologists": "archeologists",
        "encyclopaedia": "encyclopedia", "encyclopaedias": "encyclopedias",
        "mediaeval": "medieval", "leukaemia": "leukemia",
        "paediatric": "pediatric", "paediatrician": "pediatrician",
        "orthopaedic": "orthopedic", "gynaecology": "gynecology",
        "haemoglobin": "hemoglobin", "haemorrhage": "hemorrhage",
        "diarrhoea": "diarrhea", "oesophagus": "esophagus",
        "oestrogen": "estrogen", "foetus": "fetus", "foetal": "fetal",
        "amoeba": "ameba", "coeliac": "celiac",
    }.items():
        m[uk] = us

    # -ence -> -ense and assorted
    for uk, us in {
        "defence": "defense", "defences": "defenses",
        "offence": "offense", "offences": "offenses",
        "licence": "license", "licences": "licenses",
        "pretence": "pretense", "pretences": "pretenses",
        "practise": "practice", "practised": "practiced",
        "practising": "practicing", "practises": "practices",
        "grey": "gray", "greys": "grays", "greyish": "grayish",
        "tyre": "tire", "tyres": "tires",
        "kerb": "curb", "kerbs": "curbs",
        "plough": "plow", "ploughs": "plows", "ploughed": "plowed",
        "mould": "mold", "moulds": "molds", "moulded": "molded",
        "moulding": "molding", "moustache": "mustache",
        "moustaches": "mustaches", "pyjamas": "pajamas",
        "programme": "program", "programmes": "programs",
        "programmed": "programed", "gaol": "jail",
        "cheque": "check", "cheques": "checks", "chequebook": "checkbook",
        "cosy": "cozy", "draught": "draft", "draughts": "drafts",
        "aluminium": "aluminum", "aeroplane": "airplane",
        "aeroplanes": "airplanes", "artefact": "artifact",
        "artefacts": "artifacts", "axe": "ax",
        "judgement": "judgment", "judgements": "judgments",
        "acknowledgement": "acknowledgment",
        "acknowledgements": "acknowledgments",
        "ageing": "aging", "storey": "story", "storeys": "stories",
        "whilst": "while", "amongst": "among",
        "learnt": "learned", "spelt": "spelled", "spoilt": "spoiled",
        "dreamt": "dreamed", "leapt": "leaped", "burnt": "burned",
        "smelt": "smelled", "spilt": "spilled",
        "catalogue": "catalog", "catalogues": "catalogs",
        "catalogued": "cataloged", "analogue": "analog",
        "analogues": "analogs", "dialogue": "dialog",
        "dialogues": "dialogs", "monologue": "monolog",
        "epilogue": "epilog", "prologue": "prolog",
        "sulphur": "sulfur", "sulphate": "sulfate",
        "doughnut": "donut", "doughnuts": "donuts",
        "sceptic": "skeptic", "sceptical": "skeptical",
        "scepticism": "skepticism",
        "omelette": "omelet", "omelettes": "omelets",
        "tonne": "ton", "tonnes": "tons",
        "carat": "karat", "liquorice": "licorice",
        "speciality": "specialty", "specialities": "specialties",
        "manoeuvrable": "maneuverable",
    }.items():
        m[uk] = us

    return m


_DEFAULT_UK_US = _build_uk_us_mapping()


class EnglishSpellingNormalizer:
    """British -> American spelling (ref: english.py:451-462; the reference
    loads a tysto.com word list from an english.json asset missing from its
    repo — pass `mapping` to use a custom table)."""

    def __init__(self, mapping: Optional[Dict[str, str]] = None):
        self.mapping = dict(_DEFAULT_UK_US) if mapping is None else mapping

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(word, word) for word in s.split())


# ---------------------------------------------------------------------------
# the composed normalizer
# ---------------------------------------------------------------------------

class EnglishTextNormalizer:
    """Whisper English normalizer (ref: english.py:465-550): lowercase,
    strip asides/fillers, expand contractions and titles, drop symbols,
    spelled-out numbers -> digits, UK -> US spellings."""

    _IGNORE = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
    _REPLACERS = {
        # common contractions
        r"\bwon't\b": "will not",
        r"\bcan't\b": "can not",
        r"\blet's\b": "let us",
        r"\bain't\b": "aint",
        r"\by'all\b": "you all",
        r"\bwanna\b": "want to",
        r"\bgotta\b": "got to",
        r"\bgonna\b": "going to",
        r"\bi'ma\b": "i am going to",
        r"\bimma\b": "i am going to",
        r"\bwoulda\b": "would have",
        r"\bcoulda\b": "could have",
        r"\bshoulda\b": "should have",
        r"\bma'am\b": "madam",
        # titles / prefixes
        r"\bmr\b": "mister ",
        r"\bmrs\b": "missus ",
        r"\bst\b": "saint ",
        r"\bdr\b": "doctor ",
        r"\bprof\b": "professor ",
        r"\bcapt\b": "captain ",
        r"\bgov\b": "governor ",
        r"\bald\b": "alderman ",
        r"\bgen\b": "general ",
        r"\bsen\b": "senator ",
        r"\brep\b": "representative ",
        r"\bpres\b": "president ",
        r"\brev\b": "reverend ",
        r"\bhon\b": "honorable ",
        r"\basst\b": "assistant ",
        r"\bassoc\b": "associate ",
        r"\blt\b": "lieutenant ",
        r"\bcol\b": "colonel ",
        r"\bjr\b": "junior ",
        r"\bsr\b": "senior ",
        r"\besq\b": "esquire ",
        # perfect tenses
        r"'d been\b": " had been",
        r"'s been\b": " has been",
        r"'d gone\b": " had gone",
        r"'s gone\b": " has gone",
        r"'d done\b": " had done",
        r"'s got\b": " has got",
        # general contractions
        r"n't\b": " not",
        r"'re\b": " are",
        r"'s\b": " is",
        r"'d\b": " would",
        r"'ll\b": " will",
        r"'t\b": " not",
        r"'ve\b": " have",
        r"'m\b": " am",
    }

    def __init__(self, spelling_mapping: Optional[Dict[str, str]] = None):
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer(spelling_mapping)

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # bracketed asides
        s = re.sub(r"\(([^)]+?)\)", "", s)  # parenthesised asides
        s = re.sub(self._IGNORE, "", s)
        s = re.sub(r"\s+'", "'", s)  # space before apostrophe
        for pattern, replacement in self._REPLACERS.items():
            s = re.sub(pattern, replacement, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # commas between digits
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # periods not before numbers
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")

        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)

        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        s = re.sub(r"\s+", " ", s)
        return s


# ---------------------------------------------------------------------------
# digits -> words (num2words 'en' cardinal equivalent)
# ---------------------------------------------------------------------------

_SMALL_WORDS = ["zero"] + _ONES_WORDS  # 0..19
_TENS_BY_INDEX = [None, None, "twenty", "thirty", "forty", "fifty",
                  "sixty", "seventy", "eighty", "ninety"]
_SCALE_NAMES = ["", "thousand", "million", "billion", "trillion",
                "quadrillion", "quintillion", "sextillion", "septillion",
                "octillion", "nonillion", "decillion"]


def _two_words(n: int) -> str:
    if n < 20:
        return _SMALL_WORDS[n]
    tens, unit = divmod(n, 10)
    w = _TENS_BY_INDEX[tens]
    return f"{w}-{_SMALL_WORDS[unit]}" if unit else w


def _three_words(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    if not hundreds:
        return _two_words(rest)
    w = f"{_SMALL_WORDS[hundreds]} hundred"
    return f"{w} and {_two_words(rest)}" if rest else w


def _int_to_words(n: int) -> str:
    """num2words('en') cardinal: "and" inside hundreds and before a final
    sub-hundred group, commas between scale groups."""
    if n < 0:
        return "minus " + _int_to_words(-n)
    if n < 1000:
        return _three_words(n)
    groups = []
    scale = 0
    while n > 0:
        n, g = divmod(n, 1000)
        groups.append((g, scale))
        scale += 1
    if scale > len(_SCALE_NAMES):
        raise OverflowError(f"number too large for {_SCALE_NAMES[-1]}s")
    pieces = [
        (g, _three_words(g) + (f" {_SCALE_NAMES[s]}" if s else ""))
        for g, s in reversed(groups)
        if g
    ]
    out = pieces[0][1]
    for g, text in pieces[1:]:
        out += (" and " if g < 100 else ", ") + text
    return out


def number_to_words(value) -> str:
    """num2words('en') equivalent over the strings the normalizer emits:
    integers ("121" -> "one hundred and twenty-one"), signed numbers, and
    decimals ("10.25" -> "ten point two five")."""
    d = Decimal(str(value).strip())
    exponent = d.as_tuple().exponent
    if exponent >= 0 or d == d.to_integral_value():
        if exponent >= 0:
            return _int_to_words(int(d))
        # decimal with only zero fraction digits, e.g. "2.0" -> spell digits
    if d < 0:
        return "minus " + number_to_words(-d)
    precision = -exponent
    integer = int(d)
    frac_digits = str(int((d - integer) * (10 ** precision))).rjust(
        precision, "0"
    )
    return (
        _int_to_words(integer)
        + " point "
        + " ".join(_SMALL_WORDS[int(c)] for c in frac_digits)
    )


_DIGITS_RE = re.compile(r"[-+]?\d*\.?\d+|\d+%?")


class HypothesisNormalizer:
    """The reference's end-to-end `normalize()` for hypotheses and captions:
    EnglishTextNormalizer, then digits spelled back out, '%' -> ' percent'
    (ref: data/make_json_asr.py:244-252)."""

    def __init__(self, spelling_mapping: Optional[Dict[str, str]] = None):
        self.text = EnglishTextNormalizer(spelling_mapping)

    def __call__(self, s: str) -> str:
        out = self.text(s)
        try:
            return _DIGITS_RE.sub(
                lambda m: number_to_words(m.group()), out
            ).replace("%", " percent")
        except Exception:
            return out
