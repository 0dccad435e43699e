"""The serving surface: detection engines and the web demo server.

The counterpart of the JAX package's `examples/common.py` engines and
`examples/web/`: `engines` holds the engines a server or a demo drives
(`NativeEngine` on the host C++ engine, `CudaEngine` and
`CudaStreamEngine` on the card), `main` the HTTP server
(`python -m pigo_tpu_torch.web.main`) and `bench_client` its load
generator. Importing a module here starts nothing and loads neither
Pillow nor OpenCV.
"""
