"""The port's stream stages and host modes against the JAX package's.

The same command runs through both packages' modes in this process
(create_and_run_has_main of each): scan_data_stream over every stage of
io/data_stream (sources, combinators, sinks, hash-check, the cross-process
stream-src, the mxnet brick), of io/disp (data-to-img, add-img,
img-add-text, img-sink), io/render (add-img-pts), io/velodyne, io/pcap,
io/rosbag and io/video, and the modes of apps/score, the LMDB modes of
apps/eval_cls, the display modes and test_velo_crc. Each pair of runs
must print the same lines (run-varying timings scrubbed) and write the
same files, byte for byte; the blocks of each stream are compared too,
block by block (info line and values, exactly).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

import boda_tpu.modes  # noqa: F401  (register the JAX modes)
import boda_tpu_torch.modes  # noqa: F401  (register the port's)
from boda_tpu.core.has_main import create_and_run_has_main as jrun
from boda_tpu.io.data_stream import make_data_stream as jmake
from boda_tpu.io.data_stream import read_all_blocks as jread
from boda_tpu_torch.core.has_main import create_and_run_has_main as prun
from boda_tpu_torch.io.data_stream import make_data_stream as pmake
from boda_tpu_torch.io.data_stream import read_all_blocks as pread

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
VOC = DATA / "voc"
# run-varying text: scan rates and times
SCRUB = re.compile(r"took \S+s \([0-9.]+ MB/s\)")


def _both(cmd: str, tmp_path: Path, capsys, check_files: bool = True):
    """Run `cmd` (a lexp with {out} for the output dir) through both
    packages; assert the same stdout and the same output files."""
    outs = {}
    for tag, run in (("jax", jrun), ("port", prun)):
        d = tmp_path / tag
        d.mkdir()
        run(cmd.replace("{out}", str(d)) if "{out}" in cmd
            else cmd[:-1] + f",boda_output_dir={d})", global_vars={})
        outs[tag] = SCRUB.sub("SCRUBBED", capsys.readouterr().out
                              .replace(str(d), "<out>"))
    assert outs["port"] == outs["jax"]
    if check_files:
        files = {tag: sorted(p.relative_to(tmp_path / tag)
                             for p in (tmp_path / tag).rglob("*")
                             if p.is_file())
                 for tag in outs}
        assert files["port"] == files["jax"]
        for f in files["jax"]:
            assert (tmp_path / "port" / f).read_bytes() == \
                (tmp_path / "jax" / f).read_bytes(), f
    return outs["port"]


SCANS = {
    "start_stop_skip": "(mode=start-stop-skip,src=(mode=test-gen,num=6,sz=4),"
                       "skip_blocks=1)",
    "batch": "(mode=batch,n=2,src=(mode=test-gen,num=5,sz=4))",
    "crop": "(mode=pipe,stages=(_0=(mode=test-gen,num=3,sz=4),"
            "_1=(mode=crop,ysz=2,xsz=2)))",
    "text_src": f"(mode=text-src,fn={VOC / 'imgset.txt'})",
    "seq": "(mode=seq,srcs=((mode=test-gen,num=2,sz=4,tag=a),"
           "(mode=test-gen,num=3,sz=4,tag=b)))",
    "adj_angle": "(mode=pipe,stages=(_0=(mode=test-gen,num=2,sz=4),"
                 "_1=(mode=adj-angle,adj=45)))",
    "merge_flatten": "(mode=flatten,src=(mode=merge,srcs=((mode=test-gen,"
                     "num=2,tag=a),(mode=test-gen,num=2,tag=b))))",
    "ts_merge": "(mode=ts-merge,srcs=((mode=test-gen,num=3,dt_ns=1000,"
                "t0_ns=500),(mode=test-gen,num=3,dt_ns=1000,t0_ns=0)))",
    "sync": "(mode=sync,primary=(mode=test-gen,num=3,dt_ns=1000,t0_ns=100,"
            "tag=p),secondary=((mode=test-gen,num=10,dt_ns=1000,tag=s)),"
            "max_delta_ns=200)",
    "fold": "(mode=fold,src=(mode=test-gen,num=5),n=2)",
    "sort_by_ts": "(mode=sort-by-ts,window=8,src=(mode=merge,srcs="
                  "((mode=test-gen,num=3,t0_ns=900),"
                  "(mode=test-gen,num=3,t0_ns=0))))",
    "stamp_pass": "(mode=pipe,stages=(_0=(mode=test-gen,num=2,sz=4),"
                  "_1=(mode=stamp,t0_ns=77,dt_ns=3),_2=(mode=pass)))",
    "mxnet_brick_src": f"(mode=mxnet-brick-src,fn={DATA / 'brick-tiny.brick'})",
    "rosbag_src": f"(mode=rosbag-src,fn={DATA / 'bag-tiny.bag'})",
    "velodyne": "(mode=pipe,stages=(_0=(mode=velodyne,fov_rot_samps=96,"
                "fov_center=0,tot_lasers=32,vps=(mode=velodyne-gen,src=("
                "mode=velo-frame-gen,num=4,n_azi=96))),"
                "_1=(mode=velo-pcdm-to-xyz)))",
    "add_img_grey": "(mode=pipe,stages=(_0=(mode=velo-frame-gen,num=2,"
                    "n_azi=16),_1=(mode=add-img,img_fmt=16u-grey)))",
    "data_to_img": "(mode=pipe,stages=(_0=(mode=test-gen,num=2,sz=64),"
                   "_1=(mode=data-to-img)))",
    "add_img_pts": "(mode=pipe,stages=(_0=(mode=velo-frame-gen,num=2,"
                   "n_azi=32),_1=(mode=velo-pcdm-to-xyz),"
                   "_2=(mode=add-img-pts,disp_sz=48 32)))",
}


def _block_key(b):
    """A block as comparable data: its info line, its values, and its
    subblocks' (indexed and named), recursively."""
    v = None if b.nda is None else np.asarray(b.nda.v)
    subs = [_block_key(s) for s in (b.subblocks or [])]
    named = {k: _block_key(s) for k, s in sorted((b.named or {}).items())}
    return b.info_str(), v, subs, named


def _same(a, b):
    (ia, va, sa, na), (ib, vb, sb, nb) = a, b
    assert ia == ib
    if va is None or vb is None:
        assert va is None and vb is None
    else:
        assert va.dtype == vb.dtype and va.shape == vb.shape
        np.testing.assert_array_equal(va, vb)
    assert len(sa) == len(sb) and sorted(na) == sorted(nb)
    for x, y in zip(sa, sb):
        _same(x, y)
    for k in na:
        _same(na[k], nb[k])


@pytest.mark.parametrize("name", sorted(SCANS))
def test_stream_blocks_match_jax(name):
    jb = [_block_key(b) for b in jread(jmake(SCANS[name]))]
    pb = [_block_key(b) for b in pread(pmake(SCANS[name]))]
    assert len(pb) == len(jb) > 0
    for a, b in zip(pb, jb):
        _same(a, b)


@pytest.mark.parametrize("name", sorted(SCANS))
def test_scan_data_stream_matches_jax(name, tmp_path, capsys):
    out = _both(f"(mode=scan_data_stream,stream={SCANS[name]})", tmp_path,
                capsys)
    assert "scan-data-stream: " in out


SINKS = {
    "hash_check": "(mode=pipe,stages=(_0=(mode=test-gen,num=4,sz=8),"
                  "_1=(mode=hash-check,fn=digests.boda,write=1)))",
    "text_sink": "(mode=pipe,stages=(_0=(mode=test-gen,num=2),"
                 "_1=(mode=text-sink,fn={out}/o.txt)))",
    "npy_sink": "(mode=pipe,stages=(_0=(mode=test-gen,num=3,sz=2),"
                "_1=(mode=npy-sink,fn={out}/o.npy)))",
    "mxnet_brick_sink": "(mode=pipe,stages=(_0=(mode=test-gen,num=3,sz=4),"
                        "_1=(mode=mxnet-brick-sink,fn=t.brick)))",
    "pcap_sink": "(mode=pipe,stages=(_0=(mode=test-gen,num=3,sz=16),"
                 "_1=(mode=pcap-sink,fn=t.pcap)))",
    "pcap_sink_header": "(mode=pipe,stages=(_0=(mode=velodyne-gen,src=("
                        "mode=velo-frame-gen,num=2,n_azi=48)),"
                        "_1=(mode=pcap-sink,fn=v.pcap,add_header=1)))",
    "rosbag_sink": "(mode=pipe,stages=(_0=(mode=velo-frame-gen,num=2,"
                   "n_azi=16),_1=(mode=velo-pcdm-to-xyz),"
                   "_2=(mode=rosbag-sink,fn=lidar.bag)))",
    "velodyne_hash": "(mode=pipe,stages=(_0=(mode=velodyne,fov_rot_samps=96,"
                     "fov_center=0,tot_lasers=32,vps=(mode=velodyne-gen,"
                     "src=(mode=velo-frame-gen,num=4,n_azi=96))),"
                     "_1=(mode=velo-pcdm-to-xyz),"
                     "_2=(mode=hash-check,fn=pc.boda,write=1)))",
    "img_sink": "(mode=pipe,stages=(_0=(mode=test-gen,num=3,sz=64),"
                "_1=(mode=data-to-img),_2=(mode=img-sink,out_dir=frames)))",
    "render": "(mode=pipe,stages=(_0=(mode=velodyne,fov_rot_samps=96,"
              "fov_center=0,tot_lasers=32,vps=(mode=velodyne-gen,src=("
              "mode=velo-frame-gen,num=3,n_azi=96))),"
              "_1=(mode=velo-pcdm-to-xyz),_2=(mode=add-img-pts,replace=1,"
              "disp_sz=160 80),_3=(mode=img-sink,out_dir=pc)))",
    "img_add_text": "(mode=pipe,stages=(_0=(mode=test-gen,num=2,sz=64),"
                    "_1=(mode=data-to-img),_2=(mode=img-add-text,text_str=hi,"
                    "text_pos=2:2),_3=(mode=img-sink,out_dir=t)))",
    "stream_src_spawn": "(mode=pipe,stages=(_0=(mode=stream-src,spawn=("
                        "mode=test-gen,num=3,sz=4)),"
                        "_1=(mode=hash-check,fn=digests.boda,write=1)))",
    "cnet_infer_feats": "(mode=pipe,stages=(_0=(mode=test-gen,num=2,sz=64),"
                        "_1=(mode=data-to-img),_2=(mode=cnet-infer,"
                        "model=mini,top_k=2,feats_node=conv1,"
                        "feats_max_chans=8,conv_fwd=(engine=ref)),"
                        "_3=(mode=img-add-text,text_str=feats,"
                        "prefix_with_meta=0,text_pos=2:2),"
                        "_4=(mode=img-sink,out_dir=fm)))",
}


@pytest.mark.parametrize("name", sorted(SINKS))
def test_sink_files_match_jax(name, tmp_path, capsys):
    """Sinks write the same files, and read back (pcap-src over the pcap
    of the other package) give the same blocks."""
    spec = SINKS[name]
    cmd = (f"(mode=scan_data_stream,boda_output_dir={{out}},stream={spec})"
           if "{out}" in spec else f"(mode=scan_data_stream,stream={spec})")
    _both(cmd, tmp_path, capsys)
    if name.startswith("pcap_sink"):
        fn = "v.pcap" if "header" in name else "t.pcap"
        extra = ",extract_udp_payload=1" if "header" in name else ""
        src = f"(mode=pcap-src,fn={tmp_path / 'jax' / fn}{extra})"
        jb = [_block_key(b) for b in jread(jmake(src))]
        pb = [_block_key(b) for b in pread(pmake(src))]
        assert len(pb) == len(jb) > 0
        for a, b in zip(pb, jb):
            _same(a, b)


MODES = {
    "score": f"(mode=score,imgset_fn={VOC / 'imgset.txt'},ann_dir="
             f"{VOC / 'ann'},res_fns=(dog={VOC / 'results' / 'dog_test.txt'}),"
             "summary_fn=sum.txt,prc_txt_fn=prc_dog.txt)",
    "score_files": f"(mode=score_files,imgset_fn={VOC / 'imgset.txt'},"
                   f"ann_dir={VOC / 'ann'},res_fn_pat="
                   f"{VOC / 'results'}/%s_test.txt,summary_fn=summary.txt,"
                   "prc_txt_fn=prc_{cls}.txt)",
    "ham_ana": f"(mode=ham_ana,imgset_fn={VOC / 'imgset.txt'},ann_dir="
               f"{VOC / 'ann'},ham_fn_pat={VOC / 'results'}/%s_boxes_%s.csv,"
               f"dpm_fn_pat={VOC / 'results'}/%s_test.txt,classes=dog)",
    "load_pil": f"(mode=load_pil,classes_fn={VOC / 'pascal_classes.txt'},"
                f"pil_fn={VOC}/%s.txt,ann_dir={VOC / 'ann'})",
    "lmdb_parse_datums": f"(mode=lmdb_parse_datums,db_fn={DATA / 'lmdb-tiny'},"
                         "num_to_read=3)",
    "lmdb_bench": f"(mode=lmdb_bench,fn={DATA / 'lmdb-tiny'})",
    "display_lmdb": f"(mode=display_lmdb,fn={DATA / 'lmdb-tiny'},num_imgs=4,"
                    "out_fn=m.png)",
    "gen_lmdb": "(mode=gen_lmdb,out_dir=env,num_imgs=8)",
    "gen_lmdb_shapes": "(mode=gen_lmdb,out_dir=env,num_imgs=6,kind=shapes,"
                       "num_classes=4)",
    "display_test": "(mode=display_test,out_dir=frames,num_frames=2)",
    "ds_test": f"(mode=ds_test,image_fn={DATA / 'tiny16.png'},out_dir=pyr)",
    "display_raw_vid": "(mode=display_raw_vid,max_frames=2,src=(mode=pipe,"
                       "stages=(_0=(mode=velo-frame-gen,num=3,n_azi=32),"
                       "_1=(mode=add-img,img_fmt=16u-grey))),out_dir=rv)",
    "test_velo_crc": "(mode=test_velo_crc)",
}


@pytest.mark.parametrize("name", sorted(MODES))
def test_mode_matches_jax(name, tmp_path, capsys):
    _both(MODES[name], tmp_path, capsys)


def test_video_roundtrip_matches_jax(tmp_path, capsys):
    """video-sink writes a clip, video-src reads it back (OpenCV, feature
    'video'): the same blocks through both packages."""
    pytest.importorskip("cv2")
    clip = DATA / "clip-tiny.avi"
    src = f"(mode=video-src,fn={clip},max_frames=3)"
    jb = [_block_key(b) for b in jread(jmake(src))]
    pb = [_block_key(b) for b in pread(pmake(src))]
    assert len(pb) == len(jb) == 3
    for a, b in zip(pb, jb):
        _same(a, b)
