"""JSON schema -> GBNF grammar converter (the port's copy of
omni_tpu/grammar/json_schema.py).

Counterpart of the reference's common/json-schema-to-grammar.cpp (used by
the server's response_format=json_schema and tool-call constrained output).
Supports: type (incl. lists), object properties/required/additionalProperties,
array items/prefixItems/minItems/maxItems, string minLength/maxLength,
enum/const, anyOf/oneOf/allOf, $ref into #/$defs and #/definitions.
"""

from __future__ import annotations

import json
import re

SPACE_RULE = '" "?'

PRIMITIVE_RULES = {
    "boolean": '("true" | "false") space',
    "number": '("-"? ([0-9] | [1-9] [0-9]*)) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? space',
    "integer": '("-"? ([0-9] | [1-9] [0-9]*)) space',
    "string": r'"\"" char* "\"" space',
    "char": r'[^"\\\x7F\x00-\x1F] | "\\" (["\\bfnrt] | "u" [0-9a-fA-F]{4})',
    "null": '"null" space',
    "value": "object | array | string | number | boolean | null",
    "object": r'"{" space ( string ":" space value ("," space string ":" space value)* )? "}" space',
    "array": r'"[" space ( value ("," space value)* )? "]" space',
}

_INVALID_RULE_CHARS = re.compile(r"[^a-zA-Z0-9-]+")


def _format_literal(value) -> str:
    s = json.dumps(value)
    escaped = s.replace("\\", "\\\\").replace('"', '\\"')
    return f'"{escaped}"'


class SchemaConverter:
    def __init__(self, root_schema: dict | None = None):
        self._rules: dict[str, str] = {"space": SPACE_RULE}
        self._root_schema = root_schema or {}

    # -- rule table -----------------------------------------------------------
    def _add_rule(self, name: str, rule: str) -> str:
        esc = _INVALID_RULE_CHARS.sub("-", name) or "rule"
        if esc in self._rules:
            if self._rules[esc] == rule:
                return esc
            i = 0
            while f"{esc}{i}" in self._rules and self._rules[f"{esc}{i}"] != rule:
                i += 1
            esc = f"{esc}{i}"
        self._rules[esc] = rule
        return esc

    def _add_primitive(self, name: str) -> str:
        rule = PRIMITIVE_RULES[name]
        self._add_rule(name, rule)
        # primitives reference each other (string->char, value->everything)
        for dep in ("char", "object", "array", "string", "number",
                    "boolean", "null", "value"):
            if re.search(rf"\b{dep}\b", rule) and dep not in self._rules:
                self._add_primitive(dep)
        return name

    # -- schema walk ----------------------------------------------------------
    def visit(self, schema: dict | bool, name: str = "root") -> str:
        if schema is True or schema == {}:
            return self._add_rule(name, self._add_primitive("value"))
        if schema is False:
            raise ValueError("unsatisfiable schema: false")

        if "$ref" in schema:
            return self.visit(self._resolve_ref(schema["$ref"]),
                              schema["$ref"].split("/")[-1])

        if "const" in schema:
            return self._add_rule(name, _format_literal(schema["const"]) + " space")
        if "enum" in schema:
            alts = " | ".join(_format_literal(v) for v in schema["enum"])
            return self._add_rule(name, f"({alts}) space")

        for key in ("anyOf", "oneOf"):
            if key in schema:
                alts = [self.visit(s, f"{name}-{i}")
                        for i, s in enumerate(schema[key])]
                return self._add_rule(name, " | ".join(alts))
        if "allOf" in schema:
            merged: dict = {}
            for sub in schema["allOf"]:
                if "$ref" in sub:
                    sub = self._resolve_ref(sub["$ref"])
                for k, v in sub.items():
                    if k == "properties":
                        merged.setdefault("properties", {}).update(v)
                    elif k == "required":
                        merged["required"] = sorted(
                            set(merged.get("required", [])) | set(v))
                    else:
                        merged.setdefault(k, v)
            return self.visit(merged, name)

        stype = schema.get("type")
        if isinstance(stype, list):
            alts = [self.visit({**schema, "type": t}, f"{name}-{t}")
                    for t in stype]
            return self._add_rule(name, " | ".join(alts))

        if stype == "object" or (stype is None and "properties" in schema):
            return self._add_rule(name, self._object_rule(schema, name))
        if stype == "array" or (stype is None and "items" in schema):
            return self._add_rule(name, self._array_rule(schema, name))
        if stype == "string":
            return self._string_rule(schema, name)
        if stype in ("number", "integer", "boolean", "null"):
            return self._add_rule(name, self._add_primitive(stype))

        return self._add_rule(name, self._add_primitive("value"))

    def _resolve_ref(self, ref: str) -> dict:
        if not ref.startswith("#/"):
            raise ValueError(f"only local $refs supported, got {ref!r}")
        node = self._root_schema
        for part in ref[2:].split("/"):
            node = node[part.replace("~1", "/").replace("~0", "~")]
        return node

    # -- compound builders ------------------------------------------------------
    def _object_rule(self, schema: dict, name: str) -> str:
        props = schema.get("properties", {})
        required = set(schema.get("required", []))
        addl = schema.get("additionalProperties", True)

        items = []
        for key, sub in props.items():
            rule = self.visit(sub, f"{name}-{key}")
            items.append((key, rule, key in required))

        if not items:
            if addl is False:
                return '"{" space "}" space'
            return self._add_primitive("object")

        def kv(key, rule):
            return f'{_format_literal(key)} space ":" space {rule}'

        req = [(k, r) for k, r, is_req in items if is_req]
        opt = [(k, r) for k, r, is_req in items if not is_req]

        parts = ['"{" space']
        for i, (k, r) in enumerate(req):
            if i:
                parts.append('"," space')
            parts.append(kv(k, r))
        if opt:
            # every optional property may appear (in schema order), each with
            # a leading comma iff anything preceded it
            tail = " ".join(
                f'("," space {kv(k, r)})?' if req or i else
                f"({kv(k, r)} )?"
                for i, (k, r) in enumerate(opt)
            )
            if not req:
                # no required props: optional group handles its own commas
                alts = []
                for i, (k, r) in enumerate(opt):
                    rest = " ".join(f'("," space {kv(k2, r2)})?'
                                    for k2, r2 in opt[i + 1:])
                    alts.append((kv(k, r) + (" " + rest if rest else "")).strip())
                tail = "(" + " | ".join(alts) + ")?"
            parts.append(tail)
        parts.append('"}" space')
        return " ".join(parts)

    def _array_rule(self, schema: dict, name: str) -> str:
        if "prefixItems" in schema:
            rules = [self.visit(s, f"{name}-{i}")
                     for i, s in enumerate(schema["prefixItems"])]
            inner = ' "," space '.join(rules)
            return f'"[" space {inner} "]" space'
        item = self.visit(schema.get("items", True), f"{name}-item")
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if hi is not None:
            hi = int(hi)
            if hi == 0:
                return '"[" space "]" space'
            body = f'{item} ("," space {item}){{{max(lo - 1, 0)},{hi - 1}}}'
            core = f"({body})" + ("?" if lo == 0 else "")
            return f'"[" space {core} "]" space'
        if lo == 0:
            return f'"[" space ({item} ("," space {item})*)? "]" space'
        reps = f'("," space {item}){{{lo - 1},}}' if lo > 1 else f'("," space {item})*'
        return f'"[" space {item} {reps} "]" space'

    def _string_rule(self, schema: dict, name: str) -> str:
        self._add_primitive("char")
        lo = schema.get("minLength")
        hi = schema.get("maxLength")
        if lo is None and hi is None:
            return self._add_rule(name, self._add_primitive("string"))
        lo = int(lo or 0)
        rep = f"char{{{lo},{int(hi)}}}" if hi is not None else (
            f"char{{{lo},}}" if lo else "char*")
        return self._add_rule(name, f'"\\"" {rep} "\\"" space')

    # -- output -------------------------------------------------------------
    def format_grammar(self) -> str:
        lines = [f"{name} ::= {rule}"
                 for name, rule in sorted(self._rules.items(),
                                          key=lambda kv: (kv[0] != "root", kv[0]))]
        return "\n".join(lines) + "\n"


def json_schema_to_gbnf(schema: dict | str) -> str:
    """Convert a JSON schema (dict or JSON text) to a GBNF grammar string."""
    if isinstance(schema, str):
        schema = json.loads(schema)
    conv = SchemaConverter(root_schema=schema)
    conv.visit(schema, "root")
    return conv.format_grammar()
