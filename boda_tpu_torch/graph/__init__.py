"""The compute-graph IR (pipe), its support analysis and the caffe
importer: the port's copies of boda_tpu/graph/."""
