"""Top-1 of the trained 40-class GoogLeNet (tests/data/googlenet-shapes40.boda)
through the JAX package on the CPU, over the 64 held-out shapes-src images
that chip_smoke.py's zoo phase classifies on the card (start 100000, seed
1, mean 128, scale 1/64): the JAX engine's cls_agree of () against the
bf16 NHWC tune and of () against the tune the JAX bench times (Pallas
templates on their jnp fallback).

Usage:
    JAX_PLATFORMS=cpu python scripts/googlenet_heldout_top1.py
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("BODA_PALLAS_MODE", "fallback")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from boda_tpu.core.has_main import create_and_run_has_main  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "tests", "data")
SRC = ("(mode=shapes-src,num_imgs=64,start_ix=100000,ysz=224,xsz=224,"
       "num_classes=40,seed=1,mean=128,scale=0.015625)")
for tune_b in ("(prec=bf16,layout=nhwc)",
               "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"):
    print(f"a=() b={tune_b}:", flush=True)
    create_and_run_has_main(
        f"(mode=cls_agree,model=googlenet_conv,model_opts=(num_classes=40),"
        f"batch=32,weights_fn={DATA}/googlenet-shapes40.boda,src={SRC},"
        f"conv_fwd=(engine=rtc,op_tune=()),"
        f"conv_fwd_b=(engine=rtc,op_tune={tune_b}))", {})
