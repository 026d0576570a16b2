"""CLI argument parser with environment-variable mirrors (a copy of
omni_tpu/cli/args.py: the port imports nothing of the JAX package).

Capability of the reference's flag system (common/arg.cpp: every CLI flag
has an env mirror like LLAMA_ARG_CTX_SIZE): each long option --foo-bar of
an EnvArgumentParser is overridable via OMNI_ARG_FOO_BAR. Precedence:
explicit CLI flag > env var > coded default — same as the reference.
"""

from __future__ import annotations

import argparse
import os

ENV_PREFIX = "OMNI_ARG_"


def env_name(option: str) -> str:
    return ENV_PREFIX + option.lstrip("-").replace("-", "_").upper()


class EnvArgumentParser(argparse.ArgumentParser):
    def add_argument(self, *names, **kwargs):  # type: ignore[override]
        longs = [n for n in names if n.startswith("--")]
        if longs and kwargs.get("action") not in ("help", "version"):
            env = os.environ.get(env_name(longs[0]))
            if env is not None:
                action = kwargs.get("action")
                if action in ("store_true", "store_false"):
                    kwargs["default"] = env.lower() in ("1", "true", "yes", "on")
                elif action == "append":
                    kwargs["default"] = env.split(os.pathsep)
                else:
                    t = kwargs.get("type", str)
                    kwargs["default"] = t(env)
                kwargs.pop("required", None)
        return super().add_argument(*names, **kwargs)
