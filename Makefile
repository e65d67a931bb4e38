# bwtb3m developer entry points
.PHONY: test selftest bench fuzz native clean

test:
	python -m pytest tests/ -q

selftest:
	python -m bwtb3m lcpbit -test

bench:
	python bench.py

fuzz:
	python scripts/fuzz_engines.py 120

native:
	g++ -O3 -shared -fPIC -std=c++17 \
	  -o bwtb3m/native/_bwtb3m_native.so \
	  bwtb3m/native/bwtb3m_native.cpp

clean:
	rm -f bwtb3m/native/_bwtb3m_native.so
	find . -name __pycache__ -type d -exec rm -rf {} +
