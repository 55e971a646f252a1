# Build/test/render entry points (role of the reference's Makefile:1-25).

PY ?= python

.PHONY: test test-all lint native render render_ci bench dryrun clean ci

# Fast tier (<~3 min on CPU): everything except the @pytest.mark.slow
# golden/SPPM/parallel heavyweights. CI and test-all run the full suite.
test:
	$(PY) -m pytest tests/ -q -m "not slow"

test-all:
	$(PY) -m pytest tests/ -q

# Real linter (clippy -D warnings analog, cargo.yml:27-36): no ruff in
# this image and installs are forbidden, so tools/lint.py is a stdlib AST
# checker (F401/F403/F811/E501/E711/E722/B006/W291/W605/F541...).
# compileall stays as the syntax gate.
lint:
	$(PY) -m compileall -q raytracer_tpu raytracer_tpu_torch tests bench.py \
	  __graft_entry__.py chip_smoke.py
	$(PY) tools/lint.py
	$(PY) tools/lint.py raytracer_tpu_torch chip_smoke.py

native:
	g++ -O3 -march=native -shared -fPIC -std=c++17 \
	  raytracer_tpu/native/rt_native.cpp \
	  -o raytracer_tpu/native/librt_native.so -lz

# Full-quality render (the reference's `make run_release` analog)
render:
	$(PY) -m raytracer_tpu render --scene cornell --integrator sppm \
	  --width 800 --height 800 --spp 256 --out output/test.png

# Small CI render: artifact-sized workload, not thread-count games
render_ci:
	$(PY) -m raytracer_tpu render --scene cornell --integrator sppm \
	  --preset ci --out output/ci.png

bench:
	$(PY) bench.py

dryrun:
	$(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

ci: lint test render_ci

clean:
	rm -rf output .pytest_cache raytracer_tpu/native/librt_native.so \
	  raytracer_tpu_torch/_build
	find . -name __pycache__ -type d -exec rm -rf {} +
