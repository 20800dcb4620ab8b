"""Share of the window that the step loop spends in its harness span
around the next batch of train_main.device_batches (host clock): the
loader's wait and the batch's copy being queued."""


def read(rec):
    if "data_wait" not in rec.spans or not rec.window_s:
        return None
    return 100.0 * rec.spans["data_wait"] / rec.window_s
