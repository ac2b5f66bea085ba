"""Share of the checkpoint sweep's wall that the eval epochs took, as the
program's own clock reads them (``evaluate()["images_per_sec"]``: from the
epoch plan to the readback): the rest is the per-call host work around the
epoch (the serving tree, calibration, the int8 rows, the errors)."""


def read(window):
    calls = window.record.get("calls")
    if not calls:
        return None
    images = window.record["tuples"] * window.record["steps"]
    epochs = sum(images / c["images_per_sec"] for c in calls)
    return 100.0 * epochs / window.record["wall_s"]
