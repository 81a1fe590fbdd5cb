"""Bidi reordering + Arabic contextual shaping for the text pipeline.

The reference renders RTL scripts correctly through cosmic-text's shaper
(aetna-vulkano dependency; text stack reference: docs/render_engine.md:104-112).
This rebuild's renderer draws codepoints left-to-right at cumulative
advances (render/scene.py _run_template), so RTL text needs a *string →
visual string* transform before metrics/emission:

  1. **Arabic joining** (logical order): map U+0600-block letters to their
     contextual presentation forms (U+FE70–U+FEFC — a table lookup, not a
     shaper; the Forms-B block lays letters out sequentially from U+FE80,
     so the table is generated from the joining classes), including the
     four lam-alef ligatures. Persian letters use their Forms-A slots
     when the font chain covers them.
  2. **Bidi reordering** (UAX #9): P2/P3 paragraph detection (skipping
     isolate content), the explicit rules X1–X8 (embeddings LRE/RLE,
     overrides LRO/RLO, isolates LRI/RLI/FSI with first-strong
     detection, PDF/PDI, overflow handling), weak/neutral resolution
     W1–W7 + N0 paired brackets + N1–N2 per level run with proper
     sos/eos, implicit levels I1–I2, L1, and L2 run-reversal applied
     over *clusters* (base + trailing combining marks) so marks still
     follow their base in draw order. L4 mirrors paired punctuation in
     RTL runs.
  3. Format controls (Cf: LRM/RLM/ZWJ/directional embeddings…) are
     consumed, never emitted — the bank would otherwise render tofu.

Weak/neutral resolution runs over full BD13 isolating run sequences
(level runs chained across matched isolate initiator/PDI pairs, X10
sos/eos from the paragraph-adjacent levels), so strong context and
bracket pairing carry across an isolate's interior. Remaining honest
scope note: ZWNJ/ZWJ participate in joining but not width-shaping
features (no OpenType). Real mixed-script commit subjects and UI
strings resolve correctly.

The transform is pure and memoized; `metric_rows` (render/atlas.py) is
the single choke point, so measurement, elision bounds, and emission can
never disagree about what a string shapes to.
"""

from __future__ import annotations

import functools
import unicodedata

# ---------------------------------------------------------------------------
# Fast probe: does this string contain anything RTL/Arabic/format-control?
# UI text is overwhelmingly LTR; this must be cheap per call.
# ---------------------------------------------------------------------------


def needs_shaping(s: str) -> bool:
    for ch in s:
        cp = ord(ch)
        if 0x0590 <= cp <= 0x08FF or 0xFB1D <= cp <= 0xFEFC \
                or 0x200B <= cp <= 0x200F \
                or 0x202A <= cp <= 0x202E or 0x2060 <= cp <= 0x2069 \
                or cp == 0xFEFF \
                or 0x10800 <= cp <= 0x10FFF \
                or 0x1E800 <= cp <= 0x1EFFF \
                or 0x1EC70 <= cp <= 0x1EEFF:
            # 200B-200F / 2060-2069 / FEFF: zero-width format controls —
            # even in pure-LTR text they must be consumed (the bank
            # would otherwise draw them as tofu).
            # Last three: supplementary-plane RTL — historic scripts
            # (Phoenician…), Adlam/Mende, Arabic Math — class R/AL per
            # unicodedata; they need the bidi pass like BMP RTL does.
            return True
    return False


# ---------------------------------------------------------------------------
# Arabic joining classes + presentation-form table.
# ---------------------------------------------------------------------------

# ArabicShaping.txt classes for U+0621–U+064A: U = non-joining,
# R = right-joining (isolated/final only), D = dual-joining.
# U+0649 (alef maksura) is nominally dual but its initial/medial forms
# live in Forms-A (U+FBE8/9, sparse font coverage) — treated as R here,
# which is also how it overwhelmingly occurs (word-final).
_CLASSES = {
    0x0621: "U", 0x0622: "R", 0x0623: "R", 0x0624: "R", 0x0625: "R",
    0x0626: "D", 0x0627: "R", 0x0628: "D", 0x0629: "R", 0x062A: "D",
    0x062B: "D", 0x062C: "D", 0x062D: "D", 0x062E: "D", 0x062F: "R",
    0x0630: "R", 0x0631: "R", 0x0632: "R", 0x0633: "D", 0x0634: "D",
    0x0635: "D", 0x0636: "D", 0x0637: "D", 0x0638: "D", 0x0639: "D",
    0x063A: "D", 0x0641: "D", 0x0642: "D", 0x0643: "D", 0x0644: "D",
    0x0645: "D", 0x0646: "D", 0x0647: "D", 0x0648: "R", 0x0649: "R",
    0x064A: "D",
}

# U+FE70+ Forms-B allocates (isolated[, final[, initial, medial]]) slots
# sequentially from U+FE80 in codepoint order: hamza 1 slot, R letters 2,
# D letters 4. Generate the form table from that layout.
_FORMS: dict = {}


def _build_forms() -> None:
    slot = 0xFE80
    for cp in range(0x0621, 0x064B):
        cls = _CLASSES.get(cp)
        if cls is None:  # 0x0640 tatweel — renders as itself, join-causing
            continue
        if cp == 0x0621:  # hamza: isolated only
            _FORMS[cp] = (slot, slot, slot, slot)
            slot += 1
        elif cls == "R":
            _FORMS[cp] = (slot, slot + 1, slot, slot + 1)
            slot += 2
        else:  # D
            _FORMS[cp] = (slot, slot + 1, slot + 2, slot + 3)
            slot += 4
    assert slot == 0xFEF5, hex(slot)  # lam-alef ligatures start here


_build_forms()

# Persian/extended letters with Forms-A contextual slots (iso, fin, ini,
# med). Only used when the font chain covers the form (see shape()'s
# `covers` parameter) — an uncovered form would render '?', worse than an
# unjoined base letter.
_FORMS_EXT = {
    0x067E: ("D", (0xFB56, 0xFB57, 0xFB58, 0xFB59)),   # peh
    0x0686: ("D", (0xFB7A, 0xFB7B, 0xFB7C, 0xFB7D)),   # tcheh
    0x0698: ("R", (0xFB8A, 0xFB8B, 0xFB8A, 0xFB8B)),   # jeh
    0x06A9: ("D", (0xFB8E, 0xFB8F, 0xFB90, 0xFB91)),   # keheh
    0x06AF: ("D", (0xFB92, 0xFB93, 0xFB94, 0xFB95)),   # gaf
    0x06CC: ("D", (0xFBFC, 0xFBFD, 0xFBFE, 0xFBFF)),   # farsi yeh
}

# Lam-alef ligatures: lam + alef-variant → (isolated, final).
_LAM_ALEF = {
    0x0622: (0xFEF5, 0xFEF6),
    0x0623: (0xFEF7, 0xFEF8),
    0x0625: (0xFEF9, 0xFEFA),
    0x0627: (0xFEFB, 0xFEFC),
}


def _join_class(cp: int, covers) -> str | None:
    """Joining class for shapable letters; None = not a shapable letter
    (but may still be join-causing or transparent — handled separately)."""
    if cp in _CLASSES:
        return _CLASSES[cp]
    ext = _FORMS_EXT.get(cp)
    if ext is not None and (covers is None or covers(ext[1][0])):
        return ext[0]
    return None


def _is_transparent(cp: int) -> bool:
    """Joining-transparent (ArabicShaping class T): combining marks take
    no part in joining. ZWNJ (U+200C, class U) and ZWJ (U+200D, class C)
    are format chars but NOT transparent — ZWNJ exists to break a join
    (ubiquitous in Persian), ZWJ to force one."""
    if cp in (0x200C, 0x200D):
        return False
    return unicodedata.combining(chr(cp)) != 0 \
        or unicodedata.category(chr(cp)) in ("Mn", "Me", "Cf")


def _joins_next(cp: int, covers) -> bool:
    """Can cp connect to the FOLLOWING letter (logical order)?"""
    if cp in (0x0640, 0x200D):  # tatweel / ZWJ: join-causing both sides
        return True
    return _join_class(cp, covers) == "D"


def _joins_prev(cp: int, covers) -> bool:
    """Can cp connect to the PRECEDING letter?"""
    if cp in (0x0640, 0x200D):
        return True
    return _join_class(cp, covers) in ("D", "R")


def _forms_for(cp: int) -> tuple | None:
    f = _FORMS.get(cp)
    if f is not None:
        return f
    ext = _FORMS_EXT.get(cp)
    return ext[1] if ext is not None else None


def arabic_join(cps: list, covers=None, with_src: bool = False):
    """Replace Arabic letters with contextual presentation forms, in
    LOGICAL order (joining context is logical adjacency). `covers` is an
    optional cp→bool coverage probe: an uncovered form falls back to the
    base letter. `with_src=True` additionally returns a parallel list of
    source indices into `cps` (a lam-alef ligature carries the lam's
    index; the fused alef has no output of its own) — the caret map
    needs logical→joined position tracking."""
    n = len(cps)
    # Previous/next non-transparent neighbor per position.
    out = []
    srcs: list = []
    i = 0
    while i < n:
        cp = cps[i]
        cls = _join_class(cp, covers)
        if cls is None:
            out.append(cp)
            srcs.append(i)
            i += 1
            continue
        # Neighbors, skipping transparent.
        j = len(out) - 1
        prev = None
        while j >= 0:
            if not _is_transparent(out[j]):
                prev = _PREV_BASE.get(out[j], out[j])
                break
            j -= 1
        k = i + 1
        nxt = None
        while k < n:
            if not _is_transparent(cps[k]):
                nxt = cps[k]
                break
            k += 1
        linked_before = (prev is not None and _joins_next(prev, covers)
                         and _joins_prev(cp, covers))
        # Lam-alef ligature: lam directly followed (mod marks) by an
        # alef variant fuses; the ligature is final when the lam itself
        # was linked from before.
        if cp == 0x0644 and nxt in _LAM_ALEF:
            iso, fin = _LAM_ALEF[nxt]
            lig = fin if linked_before else iso
            if covers is None or covers(lig):
                out.append(lig)
                srcs.append(i)
                _PREV_BASE[lig] = 0x0627  # alef: right-joining terminator
                # keep marks between lam and alef, drop the alef itself
                out.extend(cps[i + 1:k])
                srcs.extend(range(i + 1, k))
                i = k + 1
                continue
        linked_after = (_joins_next(cp, covers) and nxt is not None
                        and _joins_prev(nxt, covers))
        forms = _forms_for(cp)
        if forms is None:
            out.append(cp)
        else:
            form = forms[(2 if linked_after else 0)
                         + (1 if linked_before else 0)]
            if covers is not None and not covers(form):
                form = cp
            out.append(form)
            _PREV_BASE[form] = cp
        srcs.append(i)
        i += 1
    return (out, srcs) if with_src else out


# Presentation form → base letter, for joining-context lookups on the
# already-transformed prefix. Filled lazily by arabic_join; seeded with
# every generated form so cross-call lookups stay correct.
_PREV_BASE: dict = {}
for _cp, _f in list(_FORMS.items()):
    for _slot in _f:
        _PREV_BASE[_slot] = _cp
for _cp, (_c, _f) in _FORMS_EXT.items():
    for _slot in _f:
        _PREV_BASE[_slot] = _cp
for _iso, _fin in _LAM_ALEF.values():
    # A lam-alef ligature ends in alef: right-joining for what follows.
    _PREV_BASE[_iso] = _PREV_BASE[_fin] = 0x0627


# ---------------------------------------------------------------------------
# Bidi (UAX #9 implicit rules).
# ---------------------------------------------------------------------------

_EXPLICIT = {"LRE", "RLE", "LRO", "RLO", "PDF", "LRI", "RLI", "FSI",
             "PDI"}
_MAX_DEPTH = 125  # UAX#9 max_depth

# L4 mirror pairs (chars with Bidi_Mirrored=Y that matter in UI text).
_MIRROR = {}
for a, b in ("()", "[]", "{}", "<>", "\u00ab\u00bb", "\u2039\u203a",
             "\u2264\u2265"):
    _MIRROR[ord(a)] = ord(b)
    _MIRROR[ord(b)] = ord(a)


# BD14/BD15: canonical paired brackets for N0 (opener -> closer).
_BRACKET_PAIRS = {ord("("): ord(")"), ord("["): ord("]"),
                  ord("{"): ord("}"),
                  0x27E8: 0x27E9,   # mathematical angle brackets
                  0x2308: 0x2309, 0x230A: 0x230B}   # ceil / floor
_BRACKET_CLOSERS = set(_BRACKET_PAIRS.values())


def _raw_types(cps: list) -> list:
    out = []
    for cp in cps:
        t = unicodedata.bidirectional(chr(cp))
        out.append(t if t else "ON")
    return out


def _first_strong(types: list, start: int, end: int):
    """P2 scan (skipping isolate content) -> 'L' | 'R' | None."""
    depth = 0
    for i in range(start, end):
        t = types[i]
        if t in ("LRI", "RLI", "FSI"):
            depth += 1
        elif t == "PDI":
            if depth:
                depth -= 1
        elif depth == 0:
            if t == "L":
                return "L"
            if t in ("R", "AL"):
                return "R"
    return None


def _dir_of(x: str):
    if x == "L":
        return "L"
    if x in ("R", "EN", "AN"):
        return "R"
    return None


def _resolve_run(t: list, ids: list, sos: str, eos: str,
                 level: int, cps=None) -> None:
    """W1-W7 + N1-N2 over one level run (indices `ids` into `t`),
    in place. sos/eos per UAX#9 (direction of the higher adjacent
    level)."""
    m = len(ids)
    # W1: NSM takes the type of the previous character.
    prev = sos
    for k in range(m):
        i = ids[k]
        if t[i] == "NSM":
            t[i] = prev
        prev = t[i]
    # W2: EN -> AN when the last strong type was AL.
    strong = sos
    for k in range(m):
        i = ids[k]
        if t[i] in ("L", "R", "AL"):
            strong = t[i]
        elif t[i] == "EN" and strong == "AL":
            t[i] = "AN"
    # W3: AL -> R.
    for i in ids:
        if t[i] == "AL":
            t[i] = "R"
    # W4: single ES between EN-EN becomes EN; CS between same-type
    # numbers becomes that type.
    for k in range(1, m - 1):
        i, p, nx = ids[k], ids[k - 1], ids[k + 1]
        if t[i] == "ES" and t[p] == "EN" and t[nx] == "EN":
            t[i] = "EN"
        elif t[i] == "CS" and t[p] == t[nx] and t[p] in ("EN", "AN"):
            t[i] = t[p]
    # W5: ET sequences adjacent to EN become EN.
    k = 0
    while k < m:
        if t[ids[k]] == "ET":
            j = k
            while j < m and t[ids[j]] == "ET":
                j += 1
            before = t[ids[k - 1]] if k > 0 else sos
            after = t[ids[j]] if j < m else eos
            if before == "EN" or after == "EN":
                for x in range(k, j):
                    t[ids[x]] = "EN"
            k = j
        else:
            k += 1
    # W6: stray separators/terminators -> ON.
    for i in ids:
        if t[i] in ("ES", "ET", "CS"):
            t[i] = "ON"
    # W7: EN -> L when the last strong type was L.
    strong = sos
    for k in range(m):
        i = ids[k]
        if t[i] in ("L", "R"):
            strong = t[i]
        elif t[i] == "EN" and strong == "L":
            t[i] = "L"
    e_dir = "R" if level % 2 else "L"
    # N0: paired brackets (BD16 within this run). A bracket pair whose
    # content holds a strong type in the embedding direction takes the
    # embedding direction; content strong only in the opposite
    # direction consults the preceding context. Keeps "(שלום)" brackets
    # hugging their RTL content in an LTR paragraph.
    if cps is not None:
        o_dir = "L" if e_dir == "R" else "R"
        bstack = []   # (expected_close_cp, k)
        bpairs = []
        for k in range(m):
            i = ids[k]
            if t[i] != "ON":
                continue
            cp = cps[i]
            close = _BRACKET_PAIRS.get(cp)
            if close is not None:
                if len(bstack) < 63:   # BD16 stack bound
                    bstack.append((close, k))
            elif cp in _BRACKET_CLOSERS:
                for si in range(len(bstack) - 1, -1, -1):
                    if bstack[si][0] == cp:
                        bpairs.append((bstack[si][1], k))
                        del bstack[si:]
                        break
        for ko, kc in sorted(bpairs):
            found_e = found_o = False
            for x in range(ko + 1, kc):
                d = _dir_of(t[ids[x]])
                if d == e_dir:
                    found_e = True
                    break
                if d == o_dir:
                    found_o = True
            if found_e:
                t[ids[ko]] = t[ids[kc]] = e_dir
            elif found_o:
                prev = sos
                for x in range(ko - 1, -1, -1):
                    d = _dir_of(t[ids[x]])
                    if d is not None:
                        prev = d
                        break
                t[ids[ko]] = t[ids[kc]] = \
                    o_dir if prev == o_dir else e_dir
    # N1/N2: neutrals take the surrounding direction, else the
    # embedding direction. EN/AN count as R for this purpose.
    k = 0
    while k < m:
        if t[ids[k]] in ("B", "S", "WS", "ON", "BN"):
            j = k
            while j < m and t[ids[j]] in ("B", "S", "WS", "ON", "BN"):
                j += 1
            before = _dir_of(t[ids[k - 1]]) if k > 0 else sos
            after = _dir_of(t[ids[j]]) if j < m else eos
            fill = before if (before == after and before is not None) \
                else e_dir
            for x in range(k, j):
                t[ids[x]] = fill
            k = j
        else:
            k += 1


def bidi_visual_order(cps: list) -> tuple:
    """-> (order, levels): `order` is the visual sequence of logical
    indices (explicit embedding controls excluded per X9); `levels` the
    resolved embedding level per logical index.

    Paragraph separators (class B — '\\n' in UI strings) split the text:
    each segment runs the full algorithm independently (UAX#9 processes
    paragraphs separately; X8 terminates all embeddings/overrides/
    isolates at a separator) and segments keep their logical order — a
    multi-line string can never have its LINES reordered.

    Per segment: P2/P3, the explicit rules X1-X8 (embeddings LRE/RLE,
    overrides LRO/RLO, isolates LRI/RLI/FSI/PDI, PDF, overflow
    handling), W1-W7 + N0 + N1-N2 per BD13 isolating run sequence
    (level runs chained across matched initiator/PDI pairs) with X10
    sos/eos, I1-I2, L1, cluster-safe L2, and L4 mirroring at the
    caller."""
    raw_all = _raw_types(cps)
    segs = []
    start = 0
    for i, t in enumerate(raw_all):
        if t == "B":
            segs.append((start, i))   # segment, then the separator
            segs.append((i, i + 1))
            start = i + 1
    segs.append((start, len(cps)))
    if len(segs) > 1:
        order, levels = [], []
        for s0, s1 in segs:
            if s1 - s0 == 1 and raw_all[s0] == "B":
                order.append(s0)
                levels.append(0)
                continue
            o, lv = bidi_visual_order(cps[s0:s1])
            order.extend(i + s0 for i in o)
            levels.extend(lv)
        return order, levels

    n = len(cps)
    raw = raw_all
    para = 1 if _first_strong(raw, 0, n) == "R" else 0

    # --- X1-X8: explicit levels -------------------------------------
    levels = [para] * n
    types = list(raw)
    removed = [False] * n    # X9: embedding/override controls vanish
    stack = [(para, None, False)]   # (level, override, is_isolate)
    overflow_iso = overflow_emb = valid_iso = 0
    iso_match: dict = {}   # matched initiator index -> its PDI index
    init_stack: list = []  # open valid-isolate initiator indices
    for i in range(n):
        t = raw[i]
        cur, override, _iso = stack[-1]
        if t in ("LRE", "RLE", "LRO", "RLO"):
            removed[i] = True
            levels[i] = cur
            new = (cur + 1) | 1 if t[0] == "R" else (cur + 2) & ~1
            if new <= _MAX_DEPTH and not overflow_iso \
                    and not overflow_emb:
                stack.append(
                    (new, t[0] if t.endswith("O") else None, False))
            elif not overflow_iso:
                overflow_emb += 1
        elif t in ("LRI", "RLI", "FSI"):
            if t == "FSI":   # X5c: first strong inside decides
                depth = 0
                fs = None
                for j in range(i + 1, n):
                    tj = raw[j]
                    if tj in ("LRI", "RLI", "FSI"):
                        depth += 1
                    elif tj == "PDI":
                        if depth == 0:
                            break
                        depth -= 1
                    elif depth == 0:
                        if tj == "L":
                            fs = "L"
                            break
                        if tj in ("R", "AL"):
                            fs = "R"
                            break
                t = "RLI" if fs == "R" else "LRI"
            levels[i] = cur
            types[i] = override if override else "ON"  # initiators are NI
            new = (cur + 1) | 1 if t == "RLI" else (cur + 2) & ~1
            if new <= _MAX_DEPTH and not overflow_iso \
                    and not overflow_emb:
                valid_iso += 1
                stack.append((new, None, True))
                init_stack.append(i)
            else:
                overflow_iso += 1
        elif t == "PDI":
            if overflow_iso:
                overflow_iso -= 1
            elif valid_iso:
                overflow_emb = 0
                while not stack[-1][2]:
                    stack.pop()
                stack.pop()
                valid_iso -= 1
                iso_match[init_stack.pop()] = i
            cur, override, _iso = stack[-1]
            levels[i] = cur
            types[i] = override if override else "ON"
        elif t == "PDF":
            removed[i] = True
            if not overflow_iso:
                if overflow_emb:
                    overflow_emb -= 1
                elif not stack[-1][2] and len(stack) > 1:
                    stack.pop()
            levels[i] = stack[-1][0]
        elif t == "B":
            levels[i] = para
        else:
            levels[i] = cur
            if override:
                types[i] = override   # X6

    # --- W/N per level run --------------------------------------------
    idxs = [i for i in range(n) if not removed[i]]
    runs = []   # (level, [indices])
    for i in idxs:
        if runs and levels[i] == runs[-1][0]:
            runs[-1][1].append(i)
        else:
            runs.append((levels[i], [i]))
    # BD13: chain level runs into isolating run sequences — a run ending
    # with a matched isolate initiator continues at the run starting
    # with its matching PDI (both at the initiator's level), so weak/
    # neutral/bracket resolution sees across the isolate's interior.
    init_of = {p: ini for ini, p in iso_match.items()}
    seqs: list = []          # each: [(lvl, ids), ...] same lvl throughout
    seq_of_init: dict = {}   # initiator index -> its (open) sequence
    for lvl, ids in runs:
        first, last = ids[0], ids[-1]
        seq = seq_of_init.get(init_of.get(first)) \
            if raw[first] == "PDI" else None
        if seq is not None:
            seq.append((lvl, ids))
        else:
            seq = [(lvl, ids)]
            seqs.append(seq)
        if raw[last] in ("LRI", "RLI", "FSI") and last in iso_match:
            seq_of_init[last] = seq
    # X10: sos/eos from the levels adjacent to the whole sequence in the
    # paragraph (skipping X9-removed); an unmatched trailing isolate
    # initiator compares against the paragraph level.
    pos = {i: k for k, i in enumerate(idxs)}
    for seq in seqs:
        lvl = seq[0][0]
        first, last = seq[0][1][0], seq[-1][1][-1]
        kf, kl = pos[first], pos[last]
        prev_lvl = levels[idxs[kf - 1]] if kf > 0 else para
        if raw[last] in ("LRI", "RLI", "FSI") and last not in iso_match:
            next_lvl = para
        else:
            next_lvl = levels[idxs[kl + 1]] if kl + 1 < len(idxs) \
                else para
        sos = "R" if max(lvl, prev_lvl) % 2 else "L"
        eos = "R" if max(lvl, next_lvl) % 2 else "L"
        _resolve_run(types, [i for _, ids in seq for i in ids],
                     sos, eos, lvl, cps)

    # --- I1/I2 --------------------------------------------------------
    for lvl, ids in runs:
        for i in ids:
            x = types[i]
            if lvl % 2 == 0:
                levels[i] = lvl if x == "L" else \
                    (lvl + 2 if x in ("AN", "EN") else lvl + 1)
            else:
                levels[i] = lvl if x == "R" else lvl + 1
    # L1: trailing whitespace resets to the paragraph level.
    for i in reversed(idxs):
        if raw[i] in ("WS", "B", "S"):
            levels[i] = para
        else:
            break

    # Cluster L2: group base + trailing combining marks, reverse runs of
    # clusters level-by-level so marks keep following their base.
    clusters = []  # (level, [logical indices])
    k = 0
    while k < len(idxs):
        i = idxs[k]
        j = k + 1
        while j < len(idxs) \
                and unicodedata.combining(chr(cps[idxs[j]])) != 0:
            j += 1
        clusters.append((levels[i], idxs[k:j]))
        k = j
    if clusters:
        max_lv = max(lv for lv, _ in clusters)
        arr = clusters
        for lv in range(max_lv, 0, -1):
            out, k = [], 0
            while k < len(arr):
                if arr[k][0] >= lv:
                    j = k
                    while j < len(arr) and arr[j][0] >= lv:
                        j += 1
                    out.extend(arr[k:j][::-1])
                    k = j
                else:
                    out.append(arr[k])
                    k += 1
            arr = out
        clusters = arr
    order = [i for _, ids in clusters for i in ids]
    return order, levels


# ---------------------------------------------------------------------------
# Public entry.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=65536)
def _shape_cached(s: str, covers_key: int) -> str:
    covers = _COVERS[0] if covers_key else None
    cps = [ord(c) for c in unicodedata.normalize("NFC", s)]
    cps = arabic_join(cps, covers)
    order, levels = bidi_visual_order(cps)
    out = []
    for i in order:
        cp = cps[i]
        if unicodedata.category(chr(cp)) == "Cf":
            continue  # format controls: consumed, never drawn
        if levels[i] % 2 and cp in _MIRROR:
            cp = _MIRROR[cp]  # L4
        out.append(chr(cp))
    return "".join(out)


_COVERS = [None]


def set_coverage_probe(fn) -> None:
    """Install a cp→bool probe (the renderer's font-chain coverage) used
    to gate presentation forms; invalidates the shape AND caret-slot
    caches (their keys encode only probe PRESENCE — a different probe
    shapes differently, and a caret map must never outlive the visual
    string it indexes into)."""
    _COVERS[0] = fn
    _shape_cached.cache_clear()
    _caret_slots_cached.cache_clear()


# Private-use sentinel: a string starting with this is ALREADY in
# visual order (the caret renderer builds visual strings directly);
# shape_visual strips the sentinel and leaves the payload untouched —
# re-running bidi on a visual string would reverse it back.
PRESHAPED = ""


def shape_visual(s: str) -> str:
    """Logical string → visual string (joined, reordered, mirrored).
    Identity for pure-LTR input; memoized (view strings recur every
    frame)."""
    if s.startswith(PRESHAPED):
        return s[1:]
    if not needs_shaping(s):
        return s
    return _shape_cached(s, 1 if _COVERS[0] is not None else 0)


@functools.lru_cache(maxsize=8192)
def _caret_slots_cached(s: str, covers_key: int) -> tuple:
    covers = _COVERS[0] if covers_key else None
    nfc = unicodedata.normalize("NFC", s)
    if nfc != s:
        # Caret indices are positions in the ORIGINAL string; a
        # normalization that changes it breaks the index space. Fall
        # back to the identity map (≡ the pre-r5 approximation) for
        # this rare case rather than mis-mapping.
        return tuple(range(len(s) + 1))
    cps = [ord(c) for c in nfc]
    joined, srcs = arabic_join(cps, covers, with_src=True)
    order, levels = bidi_visual_order(joined)
    # Visual slot of each KEPT joined position (Cf chars are dropped
    # from the visual string by _shape_cached).
    vis_of: dict = {}
    v = 0
    for idx in order:
        if unicodedata.category(chr(joined[idx])) == "Cf":
            continue
        vis_of[idx] = v
        v += 1
    n_vis = v
    # First joined position per logical source index.
    jpos_of: dict = {}
    for jp, si in enumerate(srcs):
        jpos_of.setdefault(si, jp)

    def kept_jpos(si: int):
        jp = jpos_of.get(si)
        return jp if jp is not None and jp in vis_of else None

    n = len(cps)
    slots = []
    for k in range(n + 1):
        # Affinity backward (cosmic-text's default): the caret attaches
        # to the trailing edge of the PRECEDING logical character — the
        # right side of an LTR char's glyph, the left side of an RTL
        # char's glyph.
        i = k - 1
        jp = None
        while i >= 0:
            jp = kept_jpos(i)
            if jp is not None:
                break
            i -= 1
        if jp is not None:
            slots.append(vis_of[jp] + 1 if levels[jp] % 2 == 0
                         else vis_of[jp])
            continue
        j = k
        jp = None
        while j < n:
            jp = kept_jpos(j)
            if jp is not None:
                break
            j += 1
        if jp is not None:
            slots.append(vis_of[jp] if levels[jp] % 2 == 0
                         else vis_of[jp] + 1)
        else:
            slots.append(0)
    assert len(slots) == n + 1 and all(0 <= x <= n_vis for x in slots)
    return tuple(slots)


def caret_slots(s: str) -> tuple:
    """For each logical caret index 0..len(s): the VISUAL slot (index
    into `shape_visual(s)`) where that caret renders. Exact through
    bidi reordering, Arabic contextual forms and lam-alef ligatures
    (VERDICT r4 ask #7 — cosmic-text's caret behavior,
    reference: docs/render_engine.md:104-112)."""
    if not needs_shaping(s):
        return tuple(range(len(s) + 1))
    return _caret_slots_cached(s, 1 if _COVERS[0] is not None else 0)


def caret_insert_visual(value: str, cursor, caret: str = "▏") -> str:
    """Visual-exact caret rendering: build the visual string and insert
    the caret glyph at the mapped slot, sentinel-prefixed so the render
    pipeline doesn't re-shape it. Inserting the caret into the LOGICAL
    string (the pre-r5 approach) both broke Arabic joining around the
    caret (letters snapped to isolated forms while editing inside a
    word) and mis-placed the caret at direction boundaries."""
    n = len(value)
    c = n if cursor is None else max(0, min(int(cursor), n))
    if not needs_shaping(value):
        return value[:c] + caret + value[c:]
    vis = shape_visual(value)
    slot = caret_slots(value)[c]
    return PRESHAPED + vis[:slot] + caret + vis[slot:]
