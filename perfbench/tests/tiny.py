"""Tiny sizes at which the tests drive whole runs on the CPU.

A tiny model is another configuration, with readings of its own: on the
CPU the served bfloat16 program's ``logit_err`` reads 0.012-0.03 against
the float32 reference at these sizes, and the float8 control's 0.13-0.19
(PERF.md); so the tiny configurations hold ``logit_err`` to 0.07. A
shared CPU takes tens of milliseconds an INFER, now and then hundreds: a
tiny run's requests have 2 s, so that none is dropped for that."""
TINY_LIMITS = {"logit_err": 0.07}
RESNET = {"sizes": {"widths": [8, 8, 16, 32], "image_size": 32,
                    "num_classes": 10, "buckets": [1, 2, 4],
                    "input_pool": 16, "limits": TINY_LIMITS},
          "traffic": {"rate": 40, "warmup_s": 1, "slo_ms": 2000}}
QWEN2 = {"sizes": {"serve": {"ctx": 32, "cur": 16, "buckets": [1, 2, 4],
                             "token_pool": 64}, "limits": TINY_LIMITS},
         "traffic": {"rate": 40, "warmup_s": 1, "slo_ms": 2000}}

