"""The trainer's metrics stream (counterpart of `MetricsLogger` in
srvp_tpu/utils/runtime.py; the rest of that module is TPU-only)."""

import json
import os
import time


class MetricsLogger:
    """Append-only JSONL metrics: one `{"step", "wall_s", ...}` row per
    call of `log`.

    `truncate_after` drops the rows past a resumed checkpoint's step, and a
    half-written last line: a run that died between checkpoints leaves rows
    with no matching state, and the resumed run would otherwise append a
    second copy of those steps.
    """

    def __init__(self, path, truncate_after=None):
        self.path = path
        if truncate_after is not None and os.path.exists(path):
            kept, dropped = [], 0
            with open(path) as f:
                for line in f:
                    try:
                        step = json.loads(line)["step"]
                    except (ValueError, KeyError):
                        dropped += 1
                        continue
                    if step <= truncate_after:
                        kept.append(line)
                    else:
                        dropped += 1
            if dropped:
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.writelines(kept)
                os.replace(tmp, path)
                print(f"metrics.jsonl: dropped {dropped} row(s) past resumed "
                      f"step {truncate_after}")
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step, **metrics):
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
