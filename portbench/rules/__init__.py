"""Rule kinds, one module each, found by the names a configuration's
``"rule_kinds"`` lists. The rules of kind ``<kind>`` are the
configuration's ``"<kind>_rules"`` groups (``deploy.expand``). A module
defines ``CODES`` (the fields given by name that the program takes as
codes: ``{field: (names → codes, default name or None)}``) and
``load(stt, sph, rules)``, which hands the expanded rules to the
program."""
