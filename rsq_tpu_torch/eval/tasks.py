"""The LongEval "lines" case generator (the port of
rsq_tpu.eval.tasks.generate_lines_case, which the retrieval calibration
loader draws on).  The rest of the task harness is ROADMAP item 16."""

from __future__ import annotations

LINES_HEADER = (
    "Below is a record of lines I want you to remember. "
    "Each line begins with 'line <line index>' and contains "
    "a '<REGISTER_CONTENT>' at the end of the line as a numerical value. "
    "For each line index, memorize its corresponding <REGISTER_CONTENT>. At "
    "the end of the record, I will ask you to retrieve the corresponding "
    "<REGISTER_CONTENT> of a certain line index. Now the record start:\n\n")


def generate_lines_case(num_lines: int, rng) -> dict:
    """One synthetic retrieval case from a numpy Generator."""
    values = [int(rng.integers(1, 50000)) for _ in range(num_lines)]
    body = "".join(
        f"line {i + 1}: REGISTER_CONTENT is <{values[i]}>\n"
        for i in range(num_lines))
    ask = int(rng.integers(1, num_lines + 1))
    prompt = (LINES_HEADER + body +
              f"\nNow the record is over. Tell me what is the "
              f"<REGISTER_CONTENT> in line {ask}? I need the number.")
    return {"prompt": prompt, "expected_number": values[ask - 1],
            "random_idx": ask, "num_lines": num_lines}
