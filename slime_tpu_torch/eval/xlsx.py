"""Minimal stdlib .xlsx writer (an xlsx is a zip of OOXML parts).

Exists so `mmbench_to_submission` can emit the exact artifact the MMBench eval
server ingests (reference scripts/convert_mmbench_for_submission.py:27 uses
pandas.to_excel via openpyxl; this environment has neither, and the format
needs only ~120 lines of XML). Strings are written as inline strings — no
sharedStrings table — which every reader (openpyxl, pandas, the eval server)
accepts.

The port's own copy of ``slime_tpu/eval/xlsx.py``, statement for statement.
"""
from __future__ import annotations

import zipfile
from typing import List, Optional, Sequence
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
<Override PartName="/xl/styles.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.styles+xml"/>
</Types>"""

_ROOT_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="{name}" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
<Relationship Id="rId2" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/styles" Target="styles.xml"/>
</Relationships>"""

# openpyxl requires a styles part with at least one entry per collection.
_STYLES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<styleSheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">
<fonts count="1"><font><sz val="11"/><name val="Calibri"/></font></fonts>
<fills count="1"><fill><patternFill patternType="none"/></fill></fills>
<borders count="1"><border/></borders>
<cellStyleXfs count="1"><xf/></cellStyleXfs>
<cellXfs count="1"><xf xfId="0"/></cellXfs>
</styleSheet>"""


def _col_letter(idx: int) -> str:
    """0 -> A, 25 -> Z, 26 -> AA ..."""
    out = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def _is_number(v) -> bool:
    if isinstance(v, bool):
        return False
    if isinstance(v, (int, float)):
        return True
    return False


def _clean_text(s: str) -> str:
    # XML 1.0 forbids most control chars; strip them rather than corrupt the part.
    return "".join(c for c in s if c >= " " or c in "\t\n\r")


def _cell_xml(ref: str, value) -> str:
    if value is None:
        return f'<c r="{ref}"/>'
    if _is_number(value):
        return f'<c r="{ref}"><v>{value}</v></c>'
    text = escape(_clean_text(str(value)))
    space = ' xml:space="preserve"' if text != text.strip() else ""
    return f'<c r="{ref}" t="inlineStr"><is><t{space}>{text}</t></is></c>'


def write_xlsx(path: str, header: Sequence[str], rows: List[Sequence],
               *, sheet_name: str = "Sheet1") -> str:
    """Write one worksheet: a header row then data rows (str/int/float/None cells)."""
    lines = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
             '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">',
             "<sheetData>"]
    for r, row in enumerate([list(header)] + [list(x) for x in rows]):
        cells = "".join(_cell_xml(f"{_col_letter(c)}{r + 1}", v)
                        for c, v in enumerate(row))
        lines.append(f'<row r="{r + 1}">{cells}</row>')
    lines += ["</sheetData>", "</worksheet>"]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _ROOT_RELS)
        z.writestr("xl/workbook.xml",
                   _WORKBOOK.format(name=escape(sheet_name)))
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/styles.xml", _STYLES)
        z.writestr("xl/worksheets/sheet1.xml", "\n".join(lines))
    return path


def read_xlsx(path: str) -> List[List[Optional[str]]]:
    """Tiny reader for round-trip tests (inline strings + numbers only)."""
    import re

    with zipfile.ZipFile(path) as z:
        xml = z.read("xl/worksheets/sheet1.xml").decode()
    rows: List[List[Optional[str]]] = []
    for row_xml in re.findall(r"<row [^>]*>(.*?)</row>", xml, re.S):
        cells: List[Optional[str]] = []
        for ref, _, body in re.findall(
                r'<c r="([A-Z]+\d+)"[^>]*?(/>|>(.*?)</c>)', row_xml, re.S):
            col = sum((ord(ch) - ord("A") + 1) * 26 ** i
                      for i, ch in enumerate(reversed(re.match(r"[A-Z]+", ref).group()))) - 1
            while len(cells) <= col:
                cells.append(None)
            if not body:
                continue
            m = re.search(r"<t[^>]*>(.*?)</t>", body, re.S) or \
                re.search(r"<v>(.*?)</v>", body, re.S)
            if m:
                from xml.sax.saxutils import unescape
                cells[col] = unescape(m.group(1))
        rows.append(cells)
    return rows
