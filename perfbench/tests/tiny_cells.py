"""Cells of the benchmark at sizes a CPU test can hold: the same
configurations and traffic with fewer rows, sessions and layers.  A cell
this file does not know raises, so that no CPU test runs one at its full
size."""

from core.bench import Cell

SMALL_W2V = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=128, conv_dim=[32] * 7,
                 num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
# 7 convs of 32 over 16,000 samples: 49 frames, past the 24-frame reach of
# 16 buckets, so the exact, the log-spaced and the clamped buckets are used
SMALL_WAVLM = dict(SMALL_W2V, num_buckets=16, max_bucket_distance=24)
SMALL_B64 = dict(batch=2, pool_batches=2, warmup_calls=1, slice_calls=2,
                 width=16000, min_seconds=0.3, max_seconds=1.0)


def small_cell(name: str) -> Cell:
    cell = Cell(name)
    if name == "cnn_gru.infer.b2048":
        cell.traffic.update(batch=3, pool_batches=2, warmup_calls=1,
                            slice_calls=2)
    elif name == "w2v2_base.infer.b64":
        cell.config.update(SMALL_W2V)
        cell.traffic.update(SMALL_B64)
    elif name == "wavlm_large.infer.b64":
        cell.config.update(SMALL_WAVLM)
        cell.traffic.update(SMALL_B64, batch=3)
    elif name == "cnn_gru.stream.live":
        cell.traffic.update(sessions=3, slice_seconds=2, wait_s=20)
    elif name == "cnn_gru.train.b1024":
        # 64 rows a step: a 16-row step's loss reads past the limit set at
        # 1024 rows a step, where the mean is over more rows
        cell.traffic.update(rows=384, steps_per_call=1, slice_calls=1)
        cell.traffic["recipe"] = dict(cell.traffic["recipe"], batch_size=64)
    else:
        raise KeyError(f"no small size for the cell {name!r}: add one here")
    return cell


# a window that closes a few utterances at the small cell's load
SECONDS = {"cnn_gru.stream.live": 6.0, "wavlm_large.infer.b64": 0.2}
