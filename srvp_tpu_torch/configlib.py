"""An argparse.ArgumentParser that takes `--config FILE` (counterpart of
srvp_tpu/configlib.py, copied so that the port does not import the JAX
package).

The entries of a JSON or YAML file become the flags' defaults, so flags
given on the command line override the file. File values pass through each
flag's type and choices, booleans only for flag actions, mutually exclusive
flags stay exclusive, and a required flag that the file sets is no longer
required. `.add()` aliases `.add_argument()` (configargparse's name).
"""

import argparse


def _augment_group(group):
    """Gives an argparse group the `.add` alias (recursively for mutually
    exclusive subgroups)."""
    group.add = group.add_argument
    orig_mex = group.add_mutually_exclusive_group

    def add_mutually_exclusive_group(**kwargs):
        return _augment_group(orig_mex(**kwargs))

    group.add_mutually_exclusive_group = add_mutually_exclusive_group
    return group


class ArgumentParser(argparse.ArgumentParser):
    def __init__(self, *args,
                 formatter_class=argparse.ArgumentDefaultsHelpFormatter,
                 **kwargs):
        kwargs.pop("default_config_files", None)
        super().__init__(*args, formatter_class=formatter_class, **kwargs)
        self.add_argument(
            "--config", type=str, default=None, metavar="FILE",
            help="Optional JSON/YAML file providing default values for any "
                 "flag.")

    def add(self, *args, **kwargs):
        self.add_argument(*args, **kwargs)

    def add_argument_group(self, *args, **kwargs):
        return _augment_group(super().add_argument_group(*args, **kwargs))

    def parse_args(self, args=None, namespace=None):
        # Two passes: find --config with required-ness suspended, apply the
        # file's values as defaults, then parse so that flags override them.
        saved_required = [(a, a.required) for a in self._actions]
        for a in self._actions:
            a.required = False
        try:
            pre, _ = super().parse_known_args(args)
        finally:
            for a, r in saved_required:
                a.required = r
        if getattr(pre, "config", None):
            values = _read(pre.config)
            by_dest = {a.dest: a for a in self._actions}
            unknown = set(values) - set(by_dest)
            if unknown:
                self.error(f"unknown keys in config file: {sorted(unknown)}")
            flag_actions = (argparse._StoreTrueAction,
                            argparse._StoreFalseAction,
                            argparse.BooleanOptionalAction)
            for key in list(values):
                action, val = by_dest[key], values[key]
                if val is None:
                    continue
                if isinstance(val, bool):
                    # `lr: true` must not become 1.0
                    if not isinstance(action, flag_actions):
                        self.error(
                            f"config file key {key!r}: boolean {val} is not "
                            f"a valid value for a {action.type or str} flag")
                    continue
                if action.type is not None:
                    try:
                        if isinstance(val, list):
                            val = [action.type(v) for v in val]
                        else:
                            val = action.type(val)
                    except (TypeError, ValueError) as e:
                        self.error(f"config file key {key!r}: {e}")
                    values[key] = val
                if action.choices is not None:
                    for v in val if isinstance(val, list) else [val]:
                        if v not in action.choices:
                            self.error(
                                f"config file key {key!r}: invalid choice "
                                f"{v!r} (choose from "
                                f"{', '.join(map(repr, action.choices))})")
            # file values bypass argparse's presence tracking
            for grp in self._mutually_exclusive_groups:
                given = [a for a in grp._group_actions
                         if values.get(a.dest) not in (None, False)]
                if len(given) > 1:
                    names = ", ".join(a.option_strings[0] for a in given)
                    self.error(f"config file sets mutually exclusive flags: "
                               f"{names}")
            self.set_defaults(**values)
            for a in self._actions:
                if a.dest in values:
                    a.required = False
        return super().parse_args(args, namespace)


def _read(path):
    """The dict of a .yaml/.yml (pyyaml) or JSON file."""
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml
            return yaml.safe_load(f)
        import json
        return json.load(f)
