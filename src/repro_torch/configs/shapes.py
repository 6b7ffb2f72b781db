"""LM input shapes (the LM rows of ``repro.configs.shapes``)."""

LM_SHAPES = {
    "train_4k":    dict(kind="train",   seq=4096,    batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,   batch=32),
    "decode_32k":  dict(kind="decode",  seq=32768,   batch=128),
    "long_500k":   dict(kind="decode",  seq=524288,  batch=1),
}
