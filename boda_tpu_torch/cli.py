"""The port's CLI driver: the port's copy of boda_tpu/cli.py.

Capability parity with the reference's boda.cc main / boda_main_arg_proc
(boda.cc:57-135): `<mode> --k=v ...` dispatches to a registered mode;
`help [mode]` prints hierarchical help; the timing table prints at exit;
errors are reported with stable messages. The modes are the port's own
(modes.py).

Usage:
    python -m boda_tpu_torch <mode> [--key=value ...]
    python -m boda_tpu_torch help [mode]
    python -m boda_tpu_torch '(mode=...,k=v)'    # whole-command lexp form
"""

from __future__ import annotations

import sys

from .core.config import Config
from .core.error import RtErr
from .core.has_main import HasMain, create_and_run_has_main
from .core.lexp import Lexp, get_lexp_from_argv, parse_lexp
from .core.timers import global_timer_log_finalize

# importing mode modules registers them
from . import modes  # noqa: F401


def _print_mode_list() -> None:
    print("boda_tpu_torch modes:")
    for tid, cls in sorted(Config.registered(HasMain).items()):
        print(f"  {tid:24s} {cls.HELP}")


def boda_main(argv: list[str]) -> int:
    if not argv or argv[0] in ("help", "--help", "-h"):
        if len(argv) > 1:
            subs = Config.registered(HasMain)
            cls = subs.get(argv[1])
            if cls is None:
                print(f"unknown mode '{argv[1]}'")
                _print_mode_list()
                return 1
            # hierarchical field drill-down (reference: `boda help mode
            # field...`, boda.cc:65-80)
            for field in argv[2:]:
                a = cls._attrs.get(field)
                if a is None:
                    print(f"mode '{cls.TYPE_ID or cls.__name__}' has no "
                          f"field '{field}'; fields: "
                          + ",".join(sorted(cls._attrs)))
                    return 1
                ty = a.ty
                if isinstance(ty, type) and issubclass(ty, Config):
                    cls = ty
                else:
                    print(f"--{field} <{getattr(ty, '__name__', ty)}>"
                          + (" REQUIRED" if a.req else "")
                          + (f" default={a.default!r}"
                             if a.default is not None else "")
                          + (f"  {a.help}" if a.help else ""))
                    return 0
            print(cls.help_str())
        else:
            _print_mode_list()
        return 0
    if argv[0].startswith("("):
        l = parse_lexp(argv[0])
        extra, pos = get_lexp_from_argv(argv[1:])
        for n, v in extra.iter_kids():
            l.add_key_lexp(n, v)
    else:
        l, pos = get_lexp_from_argv(argv[1:])
        ml = Lexp.empty_list()
        ml.add_key_val("mode", argv[0])
        for n, v in l.iter_kids():
            ml.add_key_lexp(n, v)
        l = ml
        if pos:
            raise RtErr(f"unexpected positional arguments: {pos}")
    create_and_run_has_main(l)
    return 0


def main() -> int:
    try:
        rc = boda_main(sys.argv[1:])
    except RtErr as e:
        print(f"error: {e}", file=sys.stderr)
        rc = 1
    except OSError as e:
        # file/socket errors surface as one-line messages, not
        # tracebacks (reference: rt_err on failed opens, §5.3 failure
        # detection); programming errors still traceback
        print(f"error: {e}", file=sys.stderr)
        rc = 1
    finally:
        global_timer_log_finalize()
    return rc


if __name__ == "__main__":
    sys.exit(main())
