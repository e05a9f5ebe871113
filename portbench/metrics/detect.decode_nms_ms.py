"""detect.decode_nms_ms (ms): device time per detect call of the kernels
launched inside the decoder (inference/detect.py:_Decoder: box decode,
greedy NMS, the table; ops/boxes.py, ops/nms.py). Moves
detect_images_per_s."""

RANGES = {"decode_nms": ["_Decoder"]}


def read(run):
    return run.range_ms_per_call("decode_nms")
