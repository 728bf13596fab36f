"""Metadata filter language — the retrieval API's filter contract. Copy
of `morphik_core_tpu/database/metadata_filters.py`.

Implements the operator set documented at reference core/api.py:356-373
and compiled in reference core/database/metadata_filters.py:29-856:

  logical:  $and, $or, $nor, $not
  field:    $eq, $ne, $gt, $gte, $lt, $lte, $in, $nin,
            $exists, $type, $regex, $contains
  implicit equality: {"field": value}
  typed metadata: per-field type hints {number, decimal, datetime,
            date, string, boolean, array, object} enable typed
            comparisons ($gt on a datetime string compares temporally).

This is an evaluator over document metadata dicts (the index and the
sqlite DB both call it); the reference's Postgres-specific SQL
generation is replaced by flattened-column SQL pre-filters + this
evaluator. Semantics:

  - $ne / $nin match documents where the field is MISSING (Mongo
    semantics, matching the reference's NOT(...) SQL shape).
  - implicit equality on an array-valued field matches if the value
    equals the array OR is an element of it.
  - ordered comparisons on incomparable/missing values are False.
"""

from __future__ import annotations

import re
from datetime import date, datetime
from decimal import Decimal, InvalidOperation
from typing import Any, Dict, Optional

VALID_TYPES = {"string", "number", "decimal", "datetime", "date", "boolean", "array", "object", "null"}

_TYPE_ALIASES = {
    "str": "string",
    "text": "string",
    "int": "number",
    "integer": "number",
    "float": "number",
    "double": "number",
    "bool": "boolean",
    "list": "array",
    "dict": "object",
    "timestamp": "datetime",
}

LOGICAL_OPS = {"$and", "$or", "$nor", "$not"}
FIELD_OPS = {"$eq", "$ne", "$gt", "$gte", "$lt", "$lte", "$in", "$nin", "$exists", "$type", "$regex", "$contains"}


class InvalidMetadataFilterError(ValueError):
    """Malformed or unsupported metadata filter."""


def canonicalize_type_name(name: str) -> str:
    n = str(name).strip().lower()
    n = _TYPE_ALIASES.get(n, n)
    if n not in VALID_TYPES:
        raise InvalidMetadataFilterError(f"unknown $type: {name!r}")
    return n


def _value_type(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float, Decimal)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (list, tuple)):
        return "array"
    if isinstance(v, dict):
        return "object"
    return "string"


_DT_FORMATS = (
    "%Y-%m-%dT%H:%M:%S.%f%z", "%Y-%m-%dT%H:%M:%S%z",
    "%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S",
    "%Y-%m-%d %H:%M:%S", "%Y-%m-%d",
)


def _try_datetime(v: Any) -> Optional[datetime]:
    if isinstance(v, datetime):
        return v
    if isinstance(v, date):
        return datetime(v.year, v.month, v.day)
    if not isinstance(v, str):
        return None
    s = v.replace("Z", "+00:00") if v.endswith("Z") else v
    try:
        return datetime.fromisoformat(s)
    except ValueError:
        pass
    for fmt in _DT_FORMATS:
        try:
            return datetime.strptime(v, fmt)
        except ValueError:
            continue
    return None


def _try_number(v: Any) -> Optional[Decimal]:
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float, Decimal)):
        try:
            d = Decimal(str(v))
        except InvalidOperation:
            return None
        # NaN/Inf parse as Decimal but ordered comparisons on them raise
        # InvalidOperation (not TypeError) — treat as non-numeric
        return d if d.is_finite() else None
    if isinstance(v, str):
        try:
            d = Decimal(v.strip())
        except InvalidOperation:
            return None
        return d if d.is_finite() else None
    return None


def _coerce_pair(left: Any, right: Any, type_hint: Optional[str]):
    """Coerce both sides for an ordered comparison. Returns None if not
    comparable."""
    if type_hint in ("number", "decimal"):
        ln, rn = _try_number(left), _try_number(right)
        return (ln, rn) if ln is not None and rn is not None else None
    if type_hint in ("datetime", "date"):
        ld, rd = _try_datetime(left), _try_datetime(right)
        if ld is None or rd is None:
            return None
        if ld.tzinfo is None:
            ld = ld.replace(tzinfo=rd.tzinfo)
        if rd.tzinfo is None:
            rd = rd.replace(tzinfo=ld.tzinfo)
        return ld, rd
    # untyped: numbers if both look numeric; datetimes if both parse and
    # at least one is a date/datetime object or the comparison value is a
    # datetime-ish string; else strings
    ln, rn = _try_number(left), _try_number(right)
    if ln is not None and rn is not None:
        return ln, rn
    ld, rd = _try_datetime(left), _try_datetime(right)
    looks_temporal = isinstance(left, (date, datetime)) or isinstance(right, (date, datetime)) or (
        isinstance(right, str) and re.match(r"^\d{4}-\d{2}-\d{2}", right) is not None
    )
    if ld is not None and rd is not None and looks_temporal:
        if ld.tzinfo is None:
            ld = ld.replace(tzinfo=rd.tzinfo)
        if rd.tzinfo is None:
            rd = rd.replace(tzinfo=ld.tzinfo)
        return ld, rd
    if isinstance(left, str) and isinstance(right, str):
        return left, right
    return None


_MISSING = object()


def _eq(actual: Any, expected: Any) -> bool:
    if actual is _MISSING:
        return False
    if isinstance(actual, bool) or isinstance(expected, bool):
        return actual is expected if isinstance(expected, bool) and isinstance(actual, bool) else actual == expected
    an, en = _try_number(actual), _try_number(expected)
    if an is not None and en is not None and not isinstance(actual, str) and not isinstance(expected, str):
        return an == en
    if actual == expected:
        return True
    # array membership for implicit equality on array-valued fields
    if isinstance(actual, (list, tuple)) and not isinstance(expected, (list, tuple)):
        return expected in actual
    return False


def _apply_field_op(op: str, actual: Any, expected: Any, type_hint: Optional[str]) -> bool:
    if op == "$eq":
        return _eq(actual, expected)
    if op == "$ne":
        return not _eq(actual, expected)
    if op in ("$gt", "$gte", "$lt", "$lte"):
        if actual is _MISSING:
            return False
        pair = _coerce_pair(actual, expected, type_hint)
        if pair is None:
            return False
        a, b = pair
        try:
            if op == "$gt":
                return a > b
            if op == "$gte":
                return a >= b
            if op == "$lt":
                return a < b
            return a <= b
        except TypeError:
            return False
    if op == "$in":
        if not isinstance(expected, (list, tuple)):
            raise InvalidMetadataFilterError("$in expects an array")
        return actual is not _MISSING and any(_eq(actual, e) for e in expected)
    if op == "$nin":
        if not isinstance(expected, (list, tuple)):
            raise InvalidMetadataFilterError("$nin expects an array")
        return actual is _MISSING or not any(_eq(actual, e) for e in expected)
    if op == "$exists":
        if not isinstance(expected, bool):
            raise InvalidMetadataFilterError("$exists expects a boolean")
        return (actual is not _MISSING) == expected
    if op == "$type":
        if actual is _MISSING:
            return False
        types = expected if isinstance(expected, (list, tuple)) else [expected]
        canon = {canonicalize_type_name(t) for t in types}
        vt = _value_type(actual)
        if vt == "number" and ("decimal" in canon or "number" in canon):
            return True
        if vt == "string":
            # typed strings: a string that parses as datetime/date counts
            if ("datetime" in canon or "date" in canon) and _try_datetime(actual) is not None:
                return True
            if ("number" in canon or "decimal" in canon) and _try_number(actual) is not None and re.match(
                r"^-?\d+(\.\d+)?$", actual.strip()
            ):
                return True
        return vt in canon
    if op == "$regex":
        if actual is _MISSING or not isinstance(actual, str):
            return False
        if not isinstance(expected, str):
            raise InvalidMetadataFilterError("$regex expects a string pattern")
        try:
            return re.search(expected, actual) is not None
        except re.error as e:
            raise InvalidMetadataFilterError(f"invalid $regex: {e}") from e
    if op == "$contains":
        if actual is _MISSING:
            return False
        if isinstance(actual, str):
            return isinstance(expected, str) and expected in actual
        if isinstance(actual, (list, tuple)):
            return any(_eq(a, expected) for a in actual)
        return False
    raise InvalidMetadataFilterError(f"unsupported operator: {op}")


def matches_filter(
    filters: Optional[Dict[str, Any]],
    metadata: Dict[str, Any],
    metadata_types: Optional[Dict[str, str]] = None,
    column_values: Optional[Dict[str, Any]] = None,
) -> bool:
    """Evaluate a filter tree against one document.

    `column_values` maps flattened column fields (e.g. filename) that are
    addressed by filters but are not part of user metadata."""
    if not filters:
        return True
    if not isinstance(filters, dict):
        raise InvalidMetadataFilterError("Metadata filters must be a JSON object.")
    metadata_types = metadata_types or {}
    column_values = column_values or {}

    def get_field(name: str) -> Any:
        if name in column_values:
            return column_values[name]
        cur: Any = metadata
        for part in name.split("."):
            if isinstance(cur, dict) and part in cur:
                cur = cur[part]
            else:
                return _MISSING
        return cur

    def eval_expr(expr: Any, context: str) -> bool:
        if not isinstance(expr, dict):
            raise InvalidMetadataFilterError(f"{context}: expected an object")
        results = []
        for key, value in expr.items():
            if key == "$and":
                _require_list(value, "$and")
                results.append(all(eval_expr(e, "$and") for e in value))
            elif key == "$or":
                _require_list(value, "$or")
                results.append(any(eval_expr(e, "$or") for e in value))
            elif key == "$nor":
                _require_list(value, "$nor")
                results.append(not any(eval_expr(e, "$nor") for e in value))
            elif key == "$not":
                results.append(not eval_expr(value, "$not"))
            elif key.startswith("$"):
                raise InvalidMetadataFilterError(f"unknown logical operator: {key}")
            else:
                results.append(eval_field(key, value))
        return all(results) if results else True

    def eval_field(field: str, cond: Any) -> bool:
        actual = get_field(field)
        hint = metadata_types.get(field)
        if isinstance(cond, dict) and any(k.startswith("$") for k in cond):
            out = True
            for op, operand in cond.items():
                if op == "$not":
                    out = out and not eval_field(field, operand)
                    continue
                if op not in FIELD_OPS:
                    raise InvalidMetadataFilterError(f"unsupported field operator: {op}")
                out = out and _apply_field_op(op, actual, operand, hint)
            return out
        return _eq(actual, cond)

    def _require_list(v: Any, op: str) -> None:
        if not isinstance(v, list) or not v:
            raise InvalidMetadataFilterError(f"{op} expects a non-empty array")

    return eval_expr(filters, "metadata filter")


# ---------------------------------------------------------------------------
# SQL compilation (SQLite json_extract), mirroring reference
# core/database/metadata_filters.py:29-856 (MetadataFilterBuilder compiles
# the same tree to Postgres jsonb SQL so retrieval never scans in Python).
#
# Contract: the compiled clause is EXACT w.r.t. matches_filter for any
# document whose metadata_types carries no hint for the fields used in
# ordered comparisons; documents WITH such hints are matched by an extra
# hint-presence disjunct and must be re-checked in Python by the caller
# (the needs-python flag below). Filters containing a leaf whose
# semantics cannot be reproduced exactly ($regex, $type, temporal string
# comparisons, array/object operands) make compile_filter_sql return
# None, and the caller falls back to full Python evaluation. Invalid
# filters raise InvalidMetadataFilterError, like matches_filter.

_TEMPORAL_RE = re.compile(r"^\d{4}-\d{2}-\d{2}")
COLUMN_FIELDS = ("filename",)


def _sql_md_num(jtype: Optional[str], value: Any) -> Optional[float]:
    """Registered SQLite helper: numeric view of a json value with the
    evaluator's coercion (_try_number), or NULL. Excludes booleans —
    json_type reports them as 'true'/'false'."""
    if jtype not in ("integer", "real", "text"):
        return None
    d = _try_number(value)
    return float(d) if d is not None else None


def register_sql_functions(conn) -> None:
    """Install the helper functions compile_filter_sql emits."""
    conn.create_function("md_num", 2, _sql_md_num, deterministic=True)


class _Bail(Exception):
    """Valid filter, but not exactly compilable — fall back to Python."""


class _SqlCompiler:
    def __init__(self, md_col: str, types_col: str):
        self.md = md_col
        self.types = types_col
        self.params: list = []
        self.ordered_fields: set = set()

    # -- helpers ------------------------------------------------------------

    def _path(self, field: str) -> str:
        parts = field.split(".")
        for p in parts:
            if not p or '"' in p or "'" in p or "\\" in p or any(ord(c) < 32 for c in p):
                raise _Bail(field)
        return "$" + "".join(f'."{p}"' for p in parts)

    def _je(self, field: str) -> str:
        if field in COLUMN_FIELDS:
            return field
        return f"json_extract({self.md}, '{self._path(field)}')"

    def _jt(self, field: str) -> str:
        if field in COLUMN_FIELDS:
            return f"(CASE WHEN {field} IS NULL THEN NULL ELSE 'text' END)"
        return f"json_type({self.md}, '{self._path(field)}')"

    def _each(self, field: str) -> str:
        return f"json_each({self.md}, '{self._path(field)}')"

    def _b(self, clause: str) -> str:
        """NULL-proof a boolean expression (SQL three-valued logic)."""
        return f"COALESCE(({clause}), 0)"

    # -- leaves ---------------------------------------------------------------

    def eq(self, field: str, v: Any) -> str:
        je, jt = self._je(field), self._jt(field)
        if v is None:
            if field in COLUMN_FIELDS:
                return self._b(f"{je} IS NULL")  # evaluator sees None == None
            return self._b(f"{jt} = 'null'")
        if isinstance(v, str):
            scalar = f"({jt} = 'text' AND {je} = ?)"
            self.params.append(v)
            if field in COLUMN_FIELDS:
                return self._b(scalar)
            member = (
                f"({jt} = 'array' AND EXISTS (SELECT 1 FROM {self._each(field)} "
                f"WHERE json_each.type = 'text' AND json_each.value = ?))"
            )
            self.params.append(v)
            return self._b(f"{scalar} OR {member}")
        if isinstance(v, bool):
            # _eq short-circuits on bool operands BEFORE the array-membership
            # branch: actual is compared with == directly, arrays never match
            self.params.append(int(v))
            return self._b(f"{je} = ?")
        if isinstance(v, (int, float)):
            scalar = f"({je} = ?)"
            self.params.append(v)
            if field in COLUMN_FIELDS:
                return self._b(scalar)
            member = (
                f"({jt} = 'array' AND EXISTS (SELECT 1 FROM {self._each(field)} "
                f"WHERE json_each.value = ?))"
            )
            self.params.append(v)
            return self._b(f"{scalar} OR {member}")
        raise _Bail(f"$eq on {type(v).__name__}")

    def ordered(self, field: str, op: str, v: Any) -> str:
        sqlop = {"$gt": ">", "$gte": ">=", "$lt": "<", "$lte": "<="}[op]
        self.ordered_fields.add(field)
        je, jt = self._je(field), self._jt(field)
        if v is None or isinstance(v, bool) or isinstance(v, (list, tuple, dict)):
            # matches_filter: incomparable operand -> always False
            return "0"
        if field in COLUMN_FIELDS:
            # filename is TEXT-or-NULL: numeric/temporal operands follow the
            # untyped coercion ladder; keep only plain string compare exact
            if isinstance(v, str) and _try_number(v) is None and not _TEMPORAL_RE.match(v):
                self.params.append(v)
                return self._b(f"{je} {sqlop} ?")
            raise _Bail("ordered op on column field with coercing operand")
        if isinstance(v, (int, float)):
            # evaluator: numeric compare when the field coerces to a number
            # (ints, reals, numeric strings; never booleans); else False
            self.params.append(float(v))
            return self._b(f"md_num({jt}, {je}) {sqlop} ?")
        if isinstance(v, str):
            if _TEMPORAL_RE.match(v):
                raise _Bail("temporal string comparison")  # datetime coercion
            num = _try_number(v)
            if num is not None:
                # numeric-string operand: numeric compare when the field
                # coerces, else lexicographic text compare
                self.params.extend([float(num), v])
                return self._b(
                    f"CASE WHEN md_num({jt}, {je}) IS NOT NULL THEN md_num({jt}, {je}) {sqlop} ? "
                    f"WHEN {jt} = 'text' THEN {je} {sqlop} ? ELSE 0 END"
                )
            self.params.append(v)
            return self._b(f"({jt} = 'text' AND {je} {sqlop} ?)")
        raise _Bail(f"ordered op on {type(v).__name__}")

    def contains(self, field: str, v: Any) -> str:
        # $contains on arrays applies _eq per element, whose own membership
        # branch looks ONE level deeper — hence the nested json_each.
        je, jt = self._je(field), self._jt(field)
        if isinstance(v, str):
            sub = f"({jt} = 'text' AND instr({je}, ?) > 0)"
            self.params.append(v)
            if field in COLUMN_FIELDS:
                return self._b(sub)
            member = (
                f"({jt} = 'array' AND EXISTS (SELECT 1 FROM {self._each(field)} AS e1 "
                f"WHERE (e1.type = 'text' AND e1.value = ?) OR (e1.type = 'array' AND "
                f"EXISTS (SELECT 1 FROM json_each(e1.value) AS e2 "
                f"WHERE e2.type = 'text' AND e2.value = ?))))"
            )
            self.params.extend([v, v])
            return self._b(f"{sub} OR {member}")
        if isinstance(v, bool):
            # _eq on a bool operand never recurses into nested arrays
            if field in COLUMN_FIELDS:
                return "0"
            self.params.append(int(v))
            return self._b(
                f"({jt} = 'array' AND EXISTS (SELECT 1 FROM {self._each(field)} "
                f"WHERE json_each.value = ?))"
            )
        if isinstance(v, (int, float)):
            if field in COLUMN_FIELDS:
                return "0"
            self.params.extend([v, v])
            return self._b(
                f"({jt} = 'array' AND EXISTS (SELECT 1 FROM {self._each(field)} AS e1 "
                f"WHERE e1.value = ? OR (e1.type = 'array' AND "
                f"EXISTS (SELECT 1 FROM json_each(e1.value) AS e2 WHERE e2.value = ?))))"
            )
        raise _Bail(f"$contains on {type(v).__name__}")

    def field_op(self, field: str, op: str, operand: Any) -> str:
        if op == "$eq":
            return self.eq(field, operand)
        if op == "$ne":
            return f"NOT {self.eq(field, operand)}"
        if op in ("$gt", "$gte", "$lt", "$lte"):
            return self.ordered(field, op, operand)
        if op == "$in":
            if not isinstance(operand, (list, tuple)):
                raise InvalidMetadataFilterError("$in expects an array")
            if not operand:
                return "0"
            return self._b(" OR ".join(self.eq(field, e) for e in operand))
        if op == "$nin":
            if not isinstance(operand, (list, tuple)):
                raise InvalidMetadataFilterError("$nin expects an array")
            if not operand:
                return "1"
            return f"NOT {self._b(' OR '.join(self.eq(field, e) for e in operand))}"
        if op == "$exists":
            if not isinstance(operand, bool):
                raise InvalidMetadataFilterError("$exists expects a boolean")
            if field in COLUMN_FIELDS:
                # column fields are always present to the evaluator (their
                # value may be None, but never _MISSING)
                return "1" if operand else "0"
            jt = self._jt(field)
            return self._b(f"{jt} IS NOT NULL" if operand else f"{jt} IS NULL")
        if op == "$contains":
            return self.contains(field, operand)
        if op in ("$regex", "$type"):
            raise _Bail(op)  # exact reproduction needs Python
        raise InvalidMetadataFilterError(f"unsupported field operator: {op}")

    def field(self, field: str, cond: Any) -> str:
        if isinstance(cond, dict) and any(k.startswith("$") for k in cond):
            parts = []
            for op, operand in cond.items():
                if op == "$not":
                    parts.append(f"NOT {self._b(self.field(field, operand))}")
                    continue
                if op not in FIELD_OPS:
                    raise InvalidMetadataFilterError(f"unsupported field operator: {op}")
                parts.append(self.field_op(field, op, operand))
            return self._b(" AND ".join(parts))
        return self.eq(field, cond)

    def expr(self, e: Any, context: str) -> str:
        if not isinstance(e, dict):
            raise InvalidMetadataFilterError(f"{context}: expected an object")
        parts = []
        for key, value in e.items():
            if key in ("$and", "$or", "$nor"):
                if not isinstance(value, list) or not value:
                    raise InvalidMetadataFilterError(f"{key} expects a non-empty array")
                joined = {"$and": " AND ", "$or": " OR ", "$nor": " OR "}[key].join(
                    self._b(self.expr(v, key)) for v in value
                )
                parts.append(f"NOT ({joined})" if key == "$nor" else f"({joined})")
            elif key == "$not":
                parts.append(f"NOT {self._b(self.expr(value, '$not'))}")
            elif key.startswith("$"):
                raise InvalidMetadataFilterError(f"unknown logical operator: {key}")
            else:
                parts.append(self.field(key, value))
        return self._b(" AND ".join(parts)) if parts else "1"


def compile_filter_sql(
    filters: Optional[Dict[str, Any]],
    md_col: str = "doc_metadata",
    types_col: str = "metadata_types",
) -> Optional[tuple]:
    """Compile a filter tree to (clause, params, needs_python_clause).

    - clause/params: SQLite WHERE fragment, exact for documents with no
      metadata_types hints on ordered-comparison fields;
    - needs_python_clause: boolean SQL expression marking rows that must
      still be checked by matches_filter (hinted fields). Rows are
      selected with `(clause OR needs_python_clause)`.

    Returns None when the filter is valid but not exactly compilable.
    Raises InvalidMetadataFilterError for invalid filters (same as
    matches_filter)."""
    if not filters:
        return None
    if not isinstance(filters, dict):
        raise InvalidMetadataFilterError("Metadata filters must be a JSON object.")
    c = _SqlCompiler(md_col, types_col)
    try:
        clause = c.expr(filters, "metadata filter")
    except _Bail:
        return None
    if c.ordered_fields:
        hint_terms = []
        for f in sorted(c.ordered_fields):
            try:
                path = c._path(f)
            except _Bail:
                return None
            hint_terms.append(f"json_extract({types_col}, '{path}') IS NOT NULL")
            if "." in f:
                # metadata_types keys dotted fields FLAT ('a.b'), which
                # the Python oracle looks up directly — probe that form
                # too, or typed dotted fields never trigger the recheck
                flat = f.replace('"', '""')
                hint_terms.append(
                    f"json_extract({types_col}, '$.\"{flat}\"') IS NOT NULL"
                )
        needs_py = "(" + " OR ".join(hint_terms) + ")"
    else:
        needs_py = "0"
    return clause, c.params, needs_py
