"""FASTA/FASTQ -> fixed-length-line format converters.

Functional equivalent of the reference ``convert -f`` / ``convert -q``
(``/root/reference/original/BGSA_CPU/convert.c:33-165``): strip headers and
(for FASTQ) quality lines, emit one sequence per line. Unlike the reference's
byte-scanner, the FASTQ path parses proper 4-line records, so quality strings
containing '@' don't corrupt the output, and both paths strip CRLF line
endings (the reference would embed the '\r' into every emitted sequence,
where the aligner's mapping table silently reads it as 'A').

The port's own copy of ``bgsa_tpu.io.fastx``, same behaviour.
"""

from __future__ import annotations


def convert_fasta(input_path: str, output_path: str) -> None:
    with open(input_path, "rb") as fin, open(output_path, "wb") as fout:
        first = True
        for line in fin:
            if line.startswith(b">"):
                if not first:
                    fout.write(b"\n")
                first = False
                continue
            fout.write(line.rstrip(b"\r\n"))
        fout.write(b"\n")


def convert_fastq(input_path: str, output_path: str) -> None:
    with open(input_path, "rb") as fin, open(output_path, "wb") as fout:
        while True:
            header = fin.readline()
            if not header:
                break
            seq = fin.readline().rstrip(b"\r\n")
            fin.readline()  # '+'
            fin.readline()  # quality
            fout.write(seq + b"\n")
