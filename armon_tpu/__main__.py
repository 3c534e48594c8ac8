"""Command-line front-end: ``python -m armon_tpu [key=value ...]``.

The reference has no CLI (`README.md:33-39`: `params = ArmonParameters(...);
armon(params)`); this thin wrapper exposes the same option space from the
shell. Values are parsed as Python literals when possible.

Examples:
    python -m armon_tpu test=Sod N=1000,1000 maxcycle=100 silent=1
    python -m armon_tpu test=Sedov data_type=float32 \\
        write_output=true output_file=sedov.csv
"""

import ast
import sys

from .params import ArmonParameters
from .core.solver import armon
from .utils.compile_cache import enable_compile_cache


def _parse(value: str):
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        # handles numbers and tuples in any spelling: 100, 1e-4, 50,50,
        # (50,50), [50,50]
        v = ast.literal_eval(value)
        return tuple(v) if isinstance(v, list) else v
    except (ValueError, SyntaxError):
        pass
    if "," in value:
        return tuple(_parse(v) for v in value.strip("()[]").split(","))
    return value


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    options = {}
    for arg in argv:
        if "=" not in arg:
            print(f"error: expected key=value, got '{arg}'", file=sys.stderr)
            return 2
        key, value = arg.split("=", 1)
        options[key] = _parse(value)
    params = ArmonParameters(**options)
    stats = armon(params)
    if params.silent < 5:
        print(stats)
    return 0


if __name__ == "__main__":
    enable_compile_cache()
    sys.exit(main())
